"""Flash attention: the wrapper of the CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

The port of the reference's Pallas kernel
(``kernels/flash_attention.py::flash_attention``): causal or full
self-attention with an online softmax, fp32 running max / sum /
accumulator.  The port keeps the model's (B, S, H, D) layout at its
interface (the kernel reads it through strides) and takes grouped-query
K/V as they are, (B, S, KH, D), indexing KV head ``h // (H // KH)``.

Two designs in the one source, chosen by :func:`flash_design` from the
dtype and the head dim, never by a failure: bf16 with D 64, 80 or 128
runs the wgmma kernel (TMA-fed, 128-query CTAs on the tensor cores; D 80,
Zamba2's shared block, on the 128-wide tiles with the columns past 80
zero-filled by TMA); fp32, and D = 32, run the SIMT kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.tsmm import check_tma

NEG_INF = -1e30
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)
WGMMA_HEAD_DIMS = (64, 80, 128)
_DESIGN = {"simt": 0, "wgmma": 1}


def flash_design(dtype, d: int) -> str:
    """The kernel design for a dtype and head dim: ``wgmma`` for bf16 with
    D in 64 / 80 / 128, ``simt`` otherwise (fp32, and D = 32)."""
    return ("wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS
            else "simt")


def _torch_attention(q, k, v, *, causal: bool):
    """Plain masked-softmax attention in fp32: q (B, Sq, H, D), k/v
    (B, Sk, KH, D) -> (B, Sq, H, D) in q's type."""
    h, kh, d = q.shape[2], k.shape[2], q.shape[3]
    g = h // kh
    kr = k.repeat_interleave(g, dim=2) if g > 1 else k
    vr = v.repeat_interleave(g, dim=2) if g > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * d ** -0.5
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr.float()).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True):
    """q (B, Sq, H, D), k/v (B, Sk, KH, D) -> (B, Sq, H, D).

    A CUDA tensor launches the kernel (D in 32/64/80/128, f32 or bf16, the
    last dim contiguous; the wgmma design also needs 16-byte aligned
    tensors with strides of a multiple of 8 elements, and raises
    otherwise); a CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return _torch_attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, sq, h, d = q.shape
    _, sk, kh, dk = k.shape
    if (k.shape != v.shape or k.shape[0] != b or dk != d or h % kh
            or d not in HEAD_DIMS):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} unsupported")
    if q.dtype not in _DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype} unsupported")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    design = flash_design(q.dtype, d)
    if design == "wgmma":
        for t, what in ((q, "q"), (k, "k"), (v, "v")):
            check_tma(t, "flash_attention", what)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lib = cuda.load()["flash_attention"]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, kh, d, *strides, int(causal), _DTYPE[q.dtype],
        _DESIGN[design], cuda.stream(q.device))
    cuda.check(rc, "flash_attention")
    cuda.count("flash_attention", f"flash_{design}")
    return out
