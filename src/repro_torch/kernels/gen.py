"""Skinny-A grammar points lowered onto the CUDA skinny kernel.

The port of the reference package's ``kernels/gen.py``, skinny-A side.
Each valid :class:`~repro_torch.kernels.variants.grammar.GenSpec` runs
the one kernel of ``csrc/tsmm_skinny.cu`` in the mode its axes ask for:

* ``ksplit>1``      — :func:`_skinny_ksplit`: fp32 partials (splits, m, N)
  from the kernel's split grid axis; the caller's ``sum(0)`` and
  :func:`_epilogue_f32` are the reduction (plain torch, outside any
  kernel, as in the reference);
* ``acc=revisit``   — :func:`_skinny_kinner` in raw-fp32 mode, then the
  cast pass with the epilogue (:func:`_epilogue_f32`);
* ``acc=vmem``      — :func:`_skinny_kinner` with the epilogue fused;
* ``epi=split``     — the kernel writes the raw sums cast to the output
  type and :func:`_split_epilogue` applies bias and activation to the
  cast result (it rounds twice, as the reference does);
* ``packfuse``      — the kernel reads the natural (K, N) weight;
* ``bres=resident`` — the same kernel: X residency is a shared-memory
  choice with the same result (see the kernel's source note).

The grid schedule has nothing to apply to on the GPU (a CUDA grid has no
dimension semantics, and ``m_split`` is tall-A only), so ``schedule`` is
accepted and ignored.  The baseline point delegates to
``ops.tsmm_skinny``.
"""

from __future__ import annotations

import dataclasses

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
