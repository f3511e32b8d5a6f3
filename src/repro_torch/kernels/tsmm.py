"""Skinny-A TSMM: the wrapper of the CUDA kernel ``csrc/tsmm_skinny.cu``
and its plain PyTorch version.

``tsmm_skinny_a`` is the port of the reference's baseline skinny-A Pallas
kernel (``kernels/tsmm.py::tsmm_skinny_a`` there): act(X @ unpack(Wp) +
bias) with fp32 accumulation and one cast.  ``kernels/gen.py`` drives the
same CUDA kernel in its other modes for the non-baseline grammar points.

A wrapper launches the kernel for a CUDA tensor and takes the plain
version only for a tensor on the CPU; there is no fallback between them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import act_ref

_ACT = {None: 0, "none": 0, "relu": 1, "silu": 2, "gelu": 3}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}

# kernel output modes (csrc/tsmm_skinny.cu)
EPILOGUE, RAW_F32 = 0, 1


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


def launch_skinny(name: str, x, w, bias, act, *, natural: bool, splits: int,
                  mode: int, bk: int = 0, bn: int = 0):
    """Run the skinny-A function on ``x``'s device: the CUDA kernel for a
    CUDA tensor (counted under ``name``), the plain version on the CPU.

    ``x`` (m, K) contiguous; ``w`` packed (nk, nn, bk, bn) or, with
    ``natural``, (K, N) with N a multiple of ``bn``; ``bias`` (N,) or None.
    Returns (m, N) in ``x``'s type, or (splits, m, N) fp32 for
    ``RAW_F32``."""
    if x.device.type == "cpu":
        return _torch_skinny(x, w, bias, act, natural=natural, splits=splits,
                             mode=mode)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
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
    out = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
           if mode == RAW_F32 else
           torch.empty((m, n), dtype=x.dtype, device=x.device))
    lib = cuda.load()["tsmm_skinny"]
    rc = lib.tsmm_skinny_launch(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, k, n, k, bk, bn, int(natural), splits, mode,
        _ACT[act], _DTYPE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    cuda.check(rc, name)
    cuda.launches[name] += 1
    return out


def tsmm_skinny_a(x, wp, bias=None, *, act=None):
    """C = act(X @ unpack(Wp) + bias).

    X (m, K) with skinny m (the decode batch, or the prefill tokens);
    Wp (nk, nn, bk, bn) packed weights with K == nk * bk; bias (nn*bn,).
    Returns (m, nn*bn) in X's type."""
    return launch_skinny("tsmm_skinny_a", x, wp, bias, act, natural=False,
                         splits=1, mode=EPILOGUE)
