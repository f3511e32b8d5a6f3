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

The grid schedule (``dims``, ``m_split``) has nothing to apply to on the
GPU (a CUDA grid has no dimension semantics and already spreads row tiles
over every SM), so it is accepted and ignored.  The
baseline points delegate to ``ops.tsmm_skinny`` / ``ops.tsmm`` /
``ops.tsmm_packed``.
"""

from __future__ import annotations

import dataclasses

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


def _tall_compute(a, b, bias, *, g, bm, bk, act, packed):
    """One tall grammar point on padded operands; ``bias``/``act`` arrive
    pre-gated (None for ``epi=split`` points)."""
    out_dtype = b.dtype
    if g.loop == "kouter":
        out = _tall_kouter(a, b, bm=bm, bk=bk, packed=packed)
        return _epilogue_f32(out, bias, act, out_dtype)
    resident = g.bres == "resident"
    if g.ksplit > 1:
        parts = _tall_ksplit(a, b, bm=bm, bk=bk, splits=g.ksplit,
                             packed=packed, resident=resident)
        return _epilogue_f32(parts.sum(0), bias, act, out_dtype)
    revisit = g.acc == "revisit"
    out = _tall_kinner(a, b, bias, bm=bm, bk=bk, act=act, packed=packed,
                       resident=resident, revisit=revisit)
    if revisit:
        out = out.to(out_dtype)
    return out


def _skinny_compute(x, w, bias, *, g, bk, bn, act, natural):
    """One grammar point on padded operands; ``bias``/``act`` arrive
    pre-gated (None for ``epi=split`` points)."""
    resident = g.bres == "resident"
    if g.ksplit > 1:
        parts = _skinny_ksplit(x, w, bk=bk, bn=bn, splits=g.ksplit,
                               natural=natural, resident=resident)
        return _epilogue_f32(parts.sum(0), bias, act, x.dtype)
    revisit = g.acc == "revisit"
    out = _skinny_kinner(x, w, bias, bk=bk, bn=bn, act=act, natural=natural,
                         resident=resident, revisit=revisit)
    if revisit:
        out = _epilogue_f32(out, bias, act, x.dtype)
    return out


def emit_tall_a(g: GenSpec, a, b, bias=None, act=None, *, bm: int = 0,
                bk: int = 0, packed: bool = False, schedule=None):
    """Lower grammar point ``g`` for the tall-A orientation.

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
    if g.ksplit > 1:
        s = split_divisor(nk, g.ksplit)
        if s != g.ksplit:
            g = dataclasses.replace(g, ksplit=s)
    fused = g.epi != "split"
    biasp = _pad_bias(bias, bp.shape[1])
    out = _tall_compute(ap, bp, biasp if fused else None, g=g, bm=bm, bk=bk,
                        act=act if fused else None, packed=packed)
    if not fused and (bias is not None or act not in (None, "none")):
        out = _split_epilogue(out, biasp, act)
    if packed:
        return out[:, :n]
    return out[:m, :n]


def emit_skinny_a(g: GenSpec, x, w, bias=None, act=None, *, bk: int = 0,
                  bn: int = 0, packed: bool = True, schedule=None):
    """Lower grammar point ``g`` for the skinny-A orientation.

    ``w`` is the packed (nk, nn, bk, bn) weight when ``packed`` else the
    natural (K, N) layout — non-packfuse points then pack it per call;
    packfuse points read the natural layout inside the kernel.  Returns
    (m, n_padded); the caller slices padded columns."""
    del schedule
    if g.packfuse and packed:
        # weight already block-major: nothing to fuse — the baseline kernel
        return ops.tsmm_skinny(x, w, bias, act=act)
    if g == BASELINE_POINT:
        if not packed:
            w = packing.pack(w, bk, bn).blocks
        return ops.tsmm_skinny(x, w, bias, act=act)
    m = x.shape[0]
    natural = bool(g.packfuse)
    if natural:
        k, n = x.shape[1], w.shape[1]
        kp, np_ = _ceil_to(k, bk), _ceil_to(n, bn)
        wq = ops.pad2(w, kp, np_).contiguous()
        nk = kp // bk
    else:
        if not packed:
            w = packing.pack(w, bk, bn).blocks
        nk, nn, bk, bn = w.shape
        wq, kp, np_ = w, nk * bk, nn * bn
    xp = ops.pad2(x, m, kp).contiguous()
    if g.ksplit > 1:
        s = split_divisor(nk, g.ksplit)
        if s != g.ksplit:
            g = dataclasses.replace(g, ksplit=s)
    fused = g.epi != "split"
    biasp = _pad_bias(bias, np_)
    out = _skinny_compute(xp, wq, biasp if fused else None, g=g, bk=bk, bn=bn,
                          act=act if fused else None, natural=natural)
    if not fused and (bias is not None or act not in (None, "none")):
        out = _split_epilogue(out, biasp, act)
    return out[:m]
