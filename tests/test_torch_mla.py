"""The port's MLA attention (``models/attention.py``) against the
reference's, and the flash kernel's gate.

The reference's ``init_mla`` params (reduced DeepSeek-V2, cast to
float32) go into the port through numpy; inputs are seeded numpy.
Tolerances: rtol = atol = 2e-4, as the reference's own
``test_mla_decode_matches_forward`` (fp32 sums in another order, and the
absorbed decode reassociates the products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.models import attention as ref_attn
from repro_torch.configs.base import get_reduced_config
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import attention as A
from repro_torch.models.param import params_from_numpy

TOL = 2e-4
ARCH = "deepseek_v2_236b"


@pytest.fixture(scope="module")
def mla():
    ref_cfg, cfg = ref_reduced_config(ARCH), get_reduced_config(ARCH)
    p, _ = ref_attn.init_mla(jax.random.PRNGKey(0), ref_cfg)
    p = jax.tree.map(lambda v: np.asarray(v, np.float32), p)
    return ref_cfg, cfg, p, params_from_numpy(p, "cpu")


def _x(cfg, b, s, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model))).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("pad", [None, (0, 3)])
def test_forward_matches_reference(mla, pad):
    ref_cfg, cfg, p, tp = mla
    x = _x(cfg, 2, 12)
    vf = None if pad is None else np.asarray(pad, np.int32)
    want, (c, kr) = ref_attn.mla_forward(
        p, ref_cfg, jnp.asarray(x), chunk=4,
        valid_from=None if vf is None else jnp.asarray(vf))
    got, (tc, tkr) = A.mla_forward(
        tp, cfg, torch.from_numpy(x), chunk=4,
        valid_from=None if vf is None else torch.from_numpy(vf))
    _close(got, want)
    _close(tc, c)
    _close(tkr, kr)


def _caches(c_kv, k_rope, b, slots, upto):
    cache_c = torch.zeros((b, slots, c_kv.shape[-1]))
    cache_kr = torch.zeros((b, slots, k_rope.shape[-1]))
    cache_c[:, :upto] = c_kv[:, :upto]
    cache_kr[:, :upto] = k_rope[:, :upto]
    return cache_c, cache_kr


@pytest.mark.parametrize("valid_from", [None, (0, 2)])
def test_decode_matches_reference(mla, valid_from):
    ref_cfg, cfg, p, tp = mla
    b, s, slots = 2, 12, 16
    x = _x(cfg, b, s, seed=1)
    _, (c_kv, k_rope) = A.mla_forward(tp, cfg, torch.from_numpy(x))
    cache_c, cache_kr = _caches(c_kv, k_rope, b, slots, s - 1)
    vf = None if valid_from is None else np.asarray(valid_from, np.int32)
    want, want_c, want_kr = ref_attn.mla_decode(
        p, ref_cfg, jnp.asarray(x[:, -1:]), jnp.asarray(cache_c.numpy()),
        jnp.asarray(cache_kr.numpy()), s - 1,
        valid_from=None if vf is None else jnp.asarray(vf))
    pos = torch.tensor(s - 1, dtype=torch.int32)
    got = A.mla_decode(tp, cfg, torch.from_numpy(x[:, -1:]), cache_c,
                       cache_kr, pos, pos.reshape(1).long(),
                       valid_from=None if vf is None
                       else torch.from_numpy(vf))
    _close(got, want)
    # the caches are written in place at the step's slot
    _close(cache_c, want_c)
    _close(cache_kr, want_kr)


def test_decode_matches_forward(mla):
    """The port alone: one absorbed decode step over the compressed cache
    of the first s - 1 tokens equals the last row of the full forward."""
    _, cfg, _, tp = mla
    b, s = 2, 12
    x = torch.from_numpy(_x(cfg, b, s, seed=2))
    full, (c_kv, k_rope) = A.mla_forward(tp, cfg, x, chunk=4)
    cache_c, cache_kr = _caches(c_kv, k_rope, b, s, s - 1)
    pos = torch.tensor(s - 1, dtype=torch.int32)
    step = A.mla_decode(tp, cfg, x[:, -1:], cache_c, cache_kr, pos,
                        pos.reshape(1).long())
    torch.testing.assert_close(step[:, 0], full[:, -1], rtol=TOL, atol=TOL)


def test_decode_with_a_device_position_equals_the_int_one(mla):
    """The 0-d position tensor (the captured decode's) and a position
    written from a Python int give the same bits; the slot is written."""
    _, cfg, _, tp = mla
    b, s = 2, 10
    x = torch.from_numpy(_x(cfg, b, s, seed=3))
    _, (c_kv, k_rope) = A.mla_forward(tp, cfg, x)
    outs = []
    for pos in (torch.tensor(s - 1, dtype=torch.int32),
                torch.full((), s - 1, dtype=torch.int64)):
        cache_c, cache_kr = _caches(c_kv, k_rope, b, s + 4, s - 1)
        outs.append((A.mla_decode(tp, cfg, x[:, -1:], cache_c, cache_kr, pos,
                                  pos.reshape(1).long()), cache_c, cache_kr))
    (a, ca, kra), (b_, cb, krb) = outs
    assert torch.equal(a, b_) and torch.equal(ca, cb) and torch.equal(kra, krb)
    assert ca[:, s - 1].abs().sum() > 0 and ca[:, s:].abs().sum() == 0


def _qkv(d, dv, *, s=256, dtype=torch.float32):
    q = torch.zeros((1, s, 2, d), dtype=dtype)
    return q, q.clone(), torch.zeros((1, s, 2, dv), dtype=dtype)


@pytest.mark.parametrize("d,dv,ok", [(128, 128, True), (64, 64, True),
                                     (32, 32, True), (192, 128, False),
                                     (128, 64, False), (96, 96, False),
                                     (256, 256, False)])
def test_flash_gate_refuses_uneven_v_and_odd_head_dims(monkeypatch, d, dv, ok):
    """The gate is a predicate of shapes, dtype and offsets: a V narrower
    than Q/K (MLA's 192 against 128) or a head dim the kernel does not
    take goes to the chunked body.  The CUDA check is stubbed so the
    predicate is read on the CPU."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    q, k, v = _qkv(d, dv)
    assert (d in HEAD_DIMS and dv == d) == ok
    assert A.flash_eligible(q, k, v, window=0, q_offset=0, k_offset=0,
                            valid_from=None) is ok


def test_flash_gate_other_conditions(monkeypatch):
    q, k, v = _qkv(128, 128)
    kw = dict(window=0, q_offset=0, k_offset=0, valid_from=None)
    assert not A.flash_eligible(q, k, v, **kw)          # a CPU tensor
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    assert A.flash_eligible(q, k, v, **kw)
    assert not A.flash_eligible(q, k, v, **{**kw, "window": 16})
    assert not A.flash_eligible(q, k, v, **{**kw, "q_offset": 4,
                                             "k_offset": 4})
    assert not A.flash_eligible(q, k, v, **{**kw, "q_offset": torch.tensor(0),
                                             "k_offset": torch.tensor(0)})
    assert not A.flash_eligible(q, k, v, **{**kw,
                                             "valid_from": torch.zeros(1)})
    assert not A.flash_eligible(*_qkv(128, 128, s=200), **kw)


def test_mla_prefill_takes_the_chunked_body(mla, monkeypatch):
    """With the device check stubbed to the card's, MLA's prefill never
    reaches the flash kernel (it would refuse dk 192 against dv 128)."""
    _, cfg, _, tp = mla
    import repro_torch.kernels.flash_attention as F

    def refuse(*a, **k):
        raise AssertionError("MLA reached the flash kernel")

    monkeypatch.setattr(F, "flash_attention", refuse)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    x = torch.from_numpy(_x(cfg, 1, 256, seed=4))
    out, _ = A.mla_forward(tp, cfg, x)
    assert out.shape == (1, 256, cfg.d_model)
