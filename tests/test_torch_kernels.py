"""The port's kernel layer on the CPU (plain versions) against the
reference's Pallas kernels in interpret mode.

Inputs come from a seeded numpy generator and go to both packages.  On
the CPU every port wrapper takes its plain PyTorch version, which must
compute the same function as the reference kernel:

* f32 within 2e-4 (the reference's own ``verify_variants`` bound), scaled
  by K/512 for k-split points, whose fp32 partial sums reassociate;
* bf16 within 2e-2 (one bf16 rounding of outputs of magnitude ~1, plus
  the ``epi=split`` points' second rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels import variants as ref_variants
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import ops, variants
from repro_torch.kernels.flash_attention import flash_attention


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    """The port's plan, measurement and miss files in a temporary
    directory (planning persists)."""
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json")):
        monkeypatch.setenv(var, str(tmp_path / name))


ACTS = (None, "relu", "silu", "gelu")


def _skinny_cases():
    seen, out = set(), []
    for prepack in (True, False):
        for spec in ref_variants.sampled_specs_for("skinny_a", prepack,
                                                   stride=3):
            if spec.key() in seen:
                continue
            seen.add(spec.key())
            g = ref_variants.from_kernel_spec(spec)
            for packed in ((False,) if g.packfuse else (True, False)):
                out.append((spec, packed))
    return [(spec, packed, dt, ACTS[i % len(ACTS)])
            for i, (spec, packed) in enumerate(out)
            for dt in ("float32", "bfloat16")]


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("spec,packed,dtype,act", _skinny_cases(),
                         ids=lambda v: getattr(v, "key", lambda: str(v))())
def test_skinny_dispatch_matches_pallas_interpret(spec, packed, dtype, act):
    rng = np.random.default_rng(7)
    m, k, n, bk, bn = 4, 1024, 384, 128, 128
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    tx, tw, tb = (_to_torch(a, dtype) for a in (x, w, b))
    if packed:
        jw, tw = ref_ops.pack_blocks(jw, bk, bn), ops.pack_blocks(tw, bk, bn)
    want = ref_variants.run_skinny_a(spec, jx, jw, jb, act, bk=bk, bn=bn,
                                     packed=packed, impl="pallas_interpret")
    got = variants.run_skinny_a(spec, tx, tw, tb, act, bk=bk, bn=bn,
                                packed=packed)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want, np.float32)[:, :n]
    got = got.float().numpy()[:, :n]
    g = ref_variants.from_kernel_spec(spec)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4 * (k / 512 if g.ksplit > 1
                                                   else 1)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,bm,bk", [((300, 520), 128, 256),
                                         ((3, 256, 384), 128, 128),
                                         ((512, 512), 512, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_layout_bit_equal_to_reference(shape, bm, bk, dtype):
    a = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ja = jnp.asarray(a).astype(dtype)
    ta = _to_torch(a, dtype)
    want = ja
    for _ in shape[:-2]:
        want = [ref_ref.pack_ref(s, bm, bk) for s in want]
    want = np.asarray(jnp.stack(want) if shape[:-2] else
                      ref_ref.pack_ref(ja, bm, bk), np.float32)
    got = ops.pack_blocks(ta, bm, bk)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.float().numpy(), want)
    assert torch.equal(ops.unpack_blocks(got, *shape[-2:]), ta)


@pytest.mark.parametrize("b,h,s,d,bq,bkv", [
    (1, 2, 64, 32, 16, 16),
    (2, 4, 128, 64, 32, 32),
    (1, 1, 128, 128, 64, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_interpret(b, h, s, d, bq, bkv, causal):
    """The shapes of tests/test_flash_kernel.py; the port takes (B,S,H,D)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, bq=bq, bkv=bkv, interpret=True)
    got = flash_attention(*(torch.from_numpy(a).transpose(1, 2)
                            for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_flash_plain_gqa_indexes_kv_head():
    """Query head h reads KV head h // (H // KH)."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 32, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 32, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 32, 2, 32)).astype(np.float32))
    got = flash_attention(q, k, v, causal=True)
    for hq in range(4):
        one = flash_attention(q[:, :, hq:hq + 1], k[:, :, hq // 2:hq // 2 + 1],
                              v[:, :, hq // 2:hq // 2 + 1], causal=True)
        torch.testing.assert_close(got[:, :, hq:hq + 1], one)


def test_variant_override_and_tall_a_dispatch(monkeypatch):
    """``REPRO_TSMM_VARIANT`` rebinds the packed path's kernel (a bad name
    raises); an unpacked tall-A problem is planned and served by the tall
    kernel's path, equal to the plain product."""
    from repro_torch.core.packing import pack
    from repro_torch.core.tsmm import tsmm_dot

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 1024)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1024, 512)).astype(np.float32))
    want = x @ w
    monkeypatch.setenv("REPRO_TSMM_VARIANT", "ksplit:splits=4")
    torch.testing.assert_close(tsmm_dot(x, pack(w, 128, 128)), want,
                               rtol=1e-4, atol=1e-3)
    monkeypatch.setenv("REPRO_TSMM_VARIANT", "no_such_variant")
    with pytest.raises(ValueError, match="unknown kernel variant"):
        tsmm_dot(x, pack(w, 128, 128))
    monkeypatch.delenv("REPRO_TSMM_VARIANT")
    tall = torch.from_numpy(rng.standard_normal((4096, 1024)).astype(np.float32))
    skinny = torch.from_numpy(rng.standard_normal((1024, 16)).astype(np.float32))
    # fp32: sums in another order over K = 1024 terms
    torch.testing.assert_close(tsmm_dot(tall, skinny), tall @ skinny,
                               rtol=1e-5, atol=1e-6 * 1024)
