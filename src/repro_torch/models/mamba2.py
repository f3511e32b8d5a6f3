"""Mamba2 (SSD, state-space duality) block: the chunked prefill scan and
the O(1)-state decode step.

The port of the reference's ``models/mamba2.py``.  The chunked SSD
algorithm cuts the sequence into Q-length chunks: within a chunk the
computation is a masked (B, Q, Q) product (attention-like), across
chunks a recurrent state (B, H, P, N) is carried, here by a Python loop
over the chunks where the reference scans.  The chunk's products and
the state update are plain ``torch`` einsums in fp32, as the reference
computes them outside any Pallas kernel; the in and out projections go
through ``core/linear.py::linear`` (the planned TSMM kernels at serve).

Semantics (held to the sequential :func:`mamba2_ref_scan` in the tests):
    h_t = exp(dt_t A) h_{t-1} + dt_t * (B_t ⊗ x_t)
    y_t = C_t · h_t + D * x_t

The decode step writes nothing: it returns the new state, and the
caller (``models/lm.py``, ``models/hybrid.py``) copies it into the
cache's slabs in place, so a captured step replays on fixed addresses.

Under tensor parallelism a rank holds whole heads: its heads' columns of
``z``, ``x`` and ``dt`` in ``w_in``, the whole ``B`` and ``C`` (every
group, each rank's heads reading them), the same channels of the conv
weight, bias and cache, its heads of ``a_log``, ``dt_bias``, ``d_skip``,
``norm`` and the ``ssm`` state, and its rows of ``w_out``.  The
reference gives ``w_in`` and the conv one column axis each over the
concatenations ``[z | x | B | C | dt]`` and ``[x | B | C]`` and lets
GSPMD cut it; a contiguous cut would put all of ``z`` on the first rank,
so every cut of those leaves goes through :func:`tp_segments` (a
deliberate divergence in layout, not in the function).  The scan and the
state update are per head and need no collective; the gated RMSNorm
sums its squares over the whole ``d_inner`` (one fp32 all-reduce,
:func:`norm_sum`) and ``w_out``'s partial sums are summed over the TP
group.

Profiler ranges (``launch/profile_decode.py`` reads them in an eager
run): ``ssm_conv`` (the causal conv), ``ssm_scan`` (the chunked scan at
prefill) and ``ssm_state`` (the state update and readout at decode).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.core.linear import linear
from repro_torch.models.layers import rmsnorm, silu
from repro_torch.models.param import ParamTree, torch_dtype
from repro_torch.sharding.context import (axis_group, cache_layout,
                                          dp_gather_cols, dp_weight_cols,
                                          gather_rows, row_start, tp_split,
                                          tp_sum)

CONV_RANGE, SCAN_RANGE, STATE_RANGE = "ssm_conv", "ssm_scan", "ssm_state"


def dims(cfg):
    """(d_inner, heads H, head dim P, state N, groups G) of the block."""
    return (cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_groups)


def tp_segments(cfg, tp: int, rank: int, width: int) -> Optional[list]:
    """The ``[start, stop)`` column ranges, in order, of rank ``rank``'s
    piece (of ``tp``) of an ``ssm_inner`` axis of full ``width``: of
    ``w_in``'s ``[z | x | B | C | dt]`` (2 d_inner + 2 G N + H) the rank's
    heads of ``z``, ``x`` and ``dt`` and the whole ``B`` and ``C``; of the
    conv's ``[x | B | C]`` (d_inner + 2 G N) the same channels; None for
    an axis of ``d_inner`` alone (``norm``, ``w_out``), which a contiguous
    cut gives its heads."""
    di, h, _, n, g = dims(cfg)
    gn = g * n
    if width == di:
        return None
    parts = {di + 2 * gn: ((di, True), (gn, False), (gn, False)),
             2 * di + 2 * gn + h: ((di, True), (di, True), (gn, False),
                                   (gn, False), (h, True))}.get(width)
    if parts is None:
        raise ValueError(f"{cfg.name}: no ssm_inner axis is {width} wide")
    out, at = [], 0
    for size, split in parts:
        w = size // tp if split else size
        lo = at + rank * w if split else at
        out.append((lo, lo + w))
        at += size
    return out


def leaf_segments(cfg, axes: tuple, shape: tuple, spec, mesh,
                  coords: Optional[dict] = None) -> Optional[list]:
    """:func:`tp_segments` of a leaf (a weight or a cache slab) of logical
    ``axes`` and full ``shape`` whose last dim its ``spec`` puts on a TP
    axis of ``mesh``, for the rank at ``coords`` (default: the first
    rank, for the piece's width); None where that dim is no segmented
    ``ssm_inner`` axis, or is whole.  Such a leaf cannot be cut without
    the model's config ``cfg``."""
    if not axes or axes[-1] != "ssm_inner" or not isinstance(spec[-1], str):
        return None
    if cfg is None:
        raise ValueError(f"an ssm_inner leaf {tuple(shape)} split over "
                         f"{spec[-1]!r} is cut by segments: pass the "
                         f"model's config (cfg=)")
    ax = spec[-1]
    return tp_segments(cfg, mesh.shape[ax], (coords or {}).get(ax, 0),
                       shape[-1])


def local_dims(p, cfg):
    """(d_inner, heads H, head dim P, state N, groups G) as the rank holds
    them: its heads, read off ``a_log``."""
    h, p_ = p["a_log"].shape[-1], cfg.ssm_head_dim
    return h * p_, h, p_, cfg.ssm_state, cfg.ssm_groups


def _uniform(gen, shape, lo: float, hi: float):
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if gen.device.type == "meta":
        return x
    return x.uniform_(lo, hi, generator=gen)


def init_mamba2(gen, cfg):
    d = cfg.d_model
    di, h, _, n, g = dims(cfg)
    conv_dim = di + 2 * g * n
    pt = ParamTree(gen, cfg.dtype)
    pt.dense("w_in", (d, 2 * di + 2 * g * n + h), ("embed", "ssm_inner"))
    conv_w = torch.randn((cfg.ssm_conv, conv_dim), dtype=torch.float32,
                         device=gen.device,
                         generator=None if gen.device.type == "meta" else gen)
    pt.add("conv_w", conv_w.mul_(0.1).to(torch_dtype(cfg.dtype)),
           ("conv", "ssm_inner"))
    pt.zeros("conv_b", (conv_dim,), ("ssm_inner",))
    a0 = _uniform(gen, (h,), 1.0, 16.0)
    pt.add("a_log", torch.log(a0), ("ssm_heads",))
    # dt_bias: inverse-softplus of dt ~ U[1e-3, 1e-1] (log-uniform)
    dt0 = torch.exp(_uniform(gen, (h,), math.log(1e-3), math.log(1e-1)))
    pt.add("dt_bias", torch.log(torch.expm1(dt0)), ("ssm_heads",))
    pt.ones("d_skip", (h,), ("ssm_heads",))
    pt.ones("norm", (di,), ("ssm_inner",))
    pt.dense("w_out", (di, d), ("ssm_inner", "embed"))
    return pt.build()


def _split_in(p, cfg, proj):
    """The in-projection's (z, xBC, dt) on the rank's heads."""
    di, h, _, n, g = local_dims(p, cfg)
    z, xc, bc, cc, dt = torch.split(proj, [di, di, g * n, g * n, h], dim=-1)
    return z, torch.cat([xc, bc, cc], dim=-1), dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv of width ``w.shape[0]`` over (B, S, C), in
    fp32 (so the full-sequence path matches the decode step's fp32 sum),
    then SiLU, cast back to ``xbc``'s type."""
    k = w.shape[0]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0)).float()
    wf = w.float()
    out = pad[:, 0:s] * wf[0][None, None]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * wf[i][None, None]
    return silu(out + b.float()[None, None]).to(xbc.dtype)


def _chunk(s: int, chunk: int) -> int:
    """The largest chunk <= ``chunk`` that divides s (ragged prefills)."""
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


def _ssd_chunked(x, dt, a_neg, bmat, cmat, h0, chunk: int):
    """Chunked SSD scan.

    x (B,S,H,P)  dt (B,S,H)  a_neg (H,) negative  bmat/cmat (B,S,G,N),
    h0 (B,H,P,N) fp32.  Returns (y (B,S,H,P) fp32, h_final (B,H,P,N)
    fp32)."""
    b, s, h, p_ = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    q = _chunk(s, chunk)
    nc = s // q
    rep = h // g

    xc = x.reshape(b, nc, q, h, p_).float()
    dtc = dt.reshape(b, nc, q, h).float()
    bc = bmat.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3).float()
    cc = cmat.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3).float()
    a = dtc * a_neg[None, None, None]            # (B,nc,Q,H), negative
    acum = torch.cumsum(a, dim=2)                # inclusive
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))

    hprev = h0
    ys = []
    for c in range(nc):
        xq, dtq, bq, cq, acq = xc[:, c], dtc[:, c], bc[:, c], cc[:, c], acum[:, c]
        # intra-chunk (the diagonal block)
        li = acq[:, :, None, :] - acq[:, None, :, :]          # (B,Qi,Qj,H)
        decay = torch.where(mask[None, :, :, None], torch.exp(li), 0.0)
        scores = (torch.einsum("bihn,bjhn->bijh", cq, bq) * decay
                  * dtq[:, None])
        y = torch.einsum("bijh,bjhp->bihp", scores, xq)
        # inter-chunk (the carried state's contribution)
        y = y + torch.einsum("bihn,bhpn,bih->bihp", cq, hprev, torch.exp(acq))
        # the state update: dt_j * decay to the chunk's end
        dte = dtq * torch.exp(acq[:, -1:, :] - acq)
        s_c = torch.einsum("bjhn,bjh,bjhp->bhpn", bq, dte, xq)
        hprev = torch.exp(acq[:, -1])[:, :, None, None] * hprev + s_c
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p_)
    return y, hprev


def norm_sum(ss, cfg):
    """The gated norm's fp32 sums of squares (..., 1) over the rank's
    channels, summed over the TP group where ``d_inner`` is split."""
    return tp_sum(ss, "ssm_inner", cfg.d_inner)


def gated_norm(y, z, scale, cfg):
    """RMSNorm of ``y * silu(z)`` over the whole ``d_inner``, as the
    reference's: where the rank holds a piece of the channels, the mean
    square is its fp32 sum of squares summed over the TP group
    (:func:`norm_sum`) over ``d_inner``."""
    g = y * silu(z)
    if not tp_split("ssm_inner", cfg.d_inner):
        return rmsnorm(g, scale, cfg.norm_eps)
    dt = g.dtype
    gf = g.float()
    ss = norm_sum(torch.sum(gf * gf, dim=-1, keepdim=True), cfg)
    gf = gf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    return (gf * scale.float()).to(dt)


def _out(p, cfg, y):
    """``w_out``, row-parallel over ``ssm_inner``: its partial sums summed
    over the TP group where the channels are split.  Its columns lie on
    the data axis under FSDP and 2D tensor parallelism: an unpacked FSDP
    piece is gathered before use (a packed one in ``tsmm_dot``), and
    under 2D the rank's columns of the output are gathered after the
    sum."""
    y = linear(y, dp_weight_cols(p["w_out"], cfg.d_model))
    y = tp_sum(y, "ssm_inner", cfg.d_inner)
    return dp_gather_cols(y, cfg.d_model)


def state_rows(b: int) -> tuple:
    """(the cell's layout, the first row, the row count) of the rows of a
    computed bucket of ``b`` rows whose state this rank holds: under 2D
    tensor parallelism every rank computes the whole bucket's
    projections while the cache's rows lie on the data axis
    (``CacheLayout.gathered``), so the conv, the scan and the state
    update run on the rank's rows (``sharding/context.py::row_start``)
    and their per-row output is gathered back (``gather_rows``);
    otherwise (None, 0, ``b``)."""
    lay = cache_layout()
    if lay is None or not lay.gathered:
        return None, 0, b
    rows = b // axis_group(lay.rows)[2]
    return lay, row_start(lay, rows), rows


def mamba2_forward(p, cfg, x, *, h0=None, conv_init=None):
    """Full-sequence Mamba2 block.  x: (B,S,d).  Returns (out (B,S,d),
    (h_final (B,H,P,N) fp32, conv_tail (B, conv-1, C))) for the cache
    handoff; ``h0`` / ``conv_init`` continue from a cached state.  Under
    a gathered cell layout (:func:`state_rows`) the conv and the scan run
    on the rank's rows, the states returned are those rows', and ``y`` is
    gathered over the rows' group before the gated norm."""
    di, h, p_, n, g = local_dims(p, cfg)
    proj = linear(x, p["w_in"])
    z, xbc_raw, dt = _split_in(p, cfg, proj)
    lay, r0, b = state_rows(x.shape[0])
    s = x.shape[1]
    if lay is not None:
        xbc_raw, dt = xbc_raw[r0:r0 + b], dt[r0:r0 + b]
    with record_function(CONV_RANGE):
        if conv_init is not None:   # continue from a cached conv tail
            full = torch.cat([conv_init.to(xbc_raw.dtype), xbc_raw], dim=1)
            xbc = _causal_conv(full, p["conv_w"],
                               p["conv_b"])[:, conv_init.shape[1]:]
        else:
            xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
        # the raw inputs the decode step's window needs (zeros before the
        # start of a prompt shorter than the window)
        tail = xbc_raw[:, -(cfg.ssm_conv - 1):]
        if tail.shape[1] < cfg.ssm_conv - 1:
            tail = F.pad(tail, (0, 0, cfg.ssm_conv - 1 - tail.shape[1], 0))
    with record_function(SCAN_RANGE):
        xs, bmat, cmat = torch.split(xbc, [di, g * n, g * n], dim=-1)
        xh = xs.reshape(b, s, h, p_)
        dtv = F.softplus(dt.float() + p["dt_bias"].float())
        a_neg = -torch.exp(p["a_log"].float())
        if h0 is None:
            h0 = torch.zeros((b, h, p_, n), dtype=torch.float32,
                             device=x.device)
        y, hfin = _ssd_chunked(xh, dtv, a_neg, bmat.reshape(b, s, g, n),
                               cmat.reshape(b, s, g, n), h0, cfg.ssm_chunk)
        y = y + p["d_skip"].float()[None, None, :, None] * xh.float()
        y = y.reshape(b, s, di).to(x.dtype)
    if lay is not None:
        y = gather_rows(lay, y)
    return _out(p, cfg, gated_norm(y, z, p["norm"], cfg)), (hfin, tail)


def mamba2_decode(p, cfg, x, ssm_state, conv_cache):
    """One-token step.  x: (B,1,d); ssm_state (B,H,P,N) fp32; conv_cache
    (B, conv-1, C) raw (pre-activation) inputs.  Returns (out (B,1,d),
    the new ssm_state, the new conv_cache); the inputs are not written.
    Under a gathered cell layout (:func:`state_rows`) the state and the
    conv window are the rank's rows of the bucket: the conv, the state
    update and the readout run on those rows, and ``y`` is gathered over
    the rows' group before the gated norm."""
    di, h, p_, n, g = local_dims(p, cfg)
    proj = linear(x[:, 0], p["w_in"])                       # (B, ...)
    z, xbc_new, dt = _split_in(p, cfg, proj)
    lay, r0, b = state_rows(x.shape[0])
    if lay is not None:
        xbc_new, dt = xbc_new[r0:r0 + b], dt[r0:r0 + b]
    with record_function(CONV_RANGE):
        window = torch.cat([conv_cache, xbc_new[:, None].to(conv_cache.dtype)],
                           dim=1)                            # (B, conv, C)
        xbc = silu(torch.einsum("bkc,kc->bc", window.float(),
                                p["conv_w"].float())
                   + p["conv_b"].float()[None]).to(x.dtype)
    with record_function(STATE_RANGE):
        xs, bvec, cvec = torch.split(xbc, [di, g * n, g * n], dim=-1)
        xh = xs.reshape(b, h, p_).float()
        bvec = bvec.reshape(b, g, n).repeat_interleave(h // g, dim=1).float()
        cvec = cvec.reshape(b, g, n).repeat_interleave(h // g, dim=1).float()
        dtv = F.softplus(dt.float() + p["dt_bias"].float())
        a_neg = -torch.exp(p["a_log"].float())
        decay = torch.exp(dtv * a_neg[None])                 # (B,H)
        ssm_state = (decay[:, :, None, None] * ssm_state
                     + dtv[:, :, None, None] * xh[..., None]
                     * bvec[:, :, None, :])
        y = torch.einsum("bhpn,bhn->bhp", ssm_state, cvec)
        y = y + p["d_skip"].float()[None, :, None] * xh
        y = y.reshape(b, di).to(x.dtype)
    if lay is not None:
        y = gather_rows(lay, y)
    y = gated_norm(y, z, p["norm"], cfg)
    return _out(p, cfg, y[:, None]), ssm_state, window[:, 1:]


def mamba2_ref_scan(p, cfg, x):
    """Sequential-scan oracle for the tests: the same params and
    semantics, one decode step per position, no chunking."""
    b, s, _ = x.shape
    di, h, p_, n, g = dims(cfg)
    ssm = torch.zeros((b, h, p_, n), dtype=torch.float32, device=x.device)
    conv = torch.zeros((b, cfg.ssm_conv - 1, di + 2 * g * n), dtype=x.dtype,
                       device=x.device)
    ys = []
    for t in range(s):
        out, ssm, conv = mamba2_decode(p, cfg, x[:, t:t + 1], ssm, conv)
        ys.append(out[:, 0])
    return torch.stack(ys, dim=1)
