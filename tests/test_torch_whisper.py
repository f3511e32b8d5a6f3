"""The port's encoder-decoder (whisper-base) against the reference, on
the CPU.

Both packages get the reference's ``init_encdec`` params through numpy.
The reduced config (2 + 2 layers, 16 frames, d_model 128) runs in
float32; ``WIDE`` enlarges it so every leaf (the tied head too) reaches
512 and packs.  The frames are seeded normals on the bf16 grid, so both
packages read the same numbers.  Tolerances: float32 logits, encoder
outputs and cache slabs within rtol = atol = 1e-4; ``slot_pos``, ``pos``
and the converted parameters exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.core import install as ref_install
from repro.core import registry as ref_registry
from repro.core.plan import buckets_for, length_buckets_for
from repro.models import attention as ref_A
from repro.models import encdec as ref_ED
from repro.models import layers as ref_layers
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import param_count as ref_param_count
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core import install, registry
from repro_torch.core.packing import PackedTensor
from repro_torch.core.plan import Problem
from repro_torch.launch.serve import make_group
from repro_torch.models import attention as A
from repro_torch.models import encdec as ED
from repro_torch.models import layers
from repro_torch.models.param import MetaGenerator, params_from_numpy
from repro_torch.models.registry import build_model, param_count
from repro_torch.serve.engine import Engine
from repro_torch.serve.programs import batch_template, check_cells
from repro_torch.serve.scheduler import ContinuousScheduler

ARCH = "whisper_base"
WIDE = dict(d_model=512, num_heads=4, num_kv_heads=4, head_dim=128,
            d_ff=1024)
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def port_cache(tmp_path_factory):
    """The port's plan, measurement and miss files (and the reference's
    plan file) in a temporary directory for the module."""
    d = tmp_path_factory.mktemp("port_cache")
    with pytest.MonkeyPatch.context() as mp:
        for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                          ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                          ("REPRO_TORCH_MISS_LOG", "misses.json"),
                          ("REPRO_PLAN_CACHE", "ref_plans.json")):
            mp.setenv(var, str(d / name))
        registry.clear_memory()
        ref_registry.clear_memory()
        yield
        registry.clear_memory()
        ref_registry.clear_memory()


def configs(wide=False):
    over = dict(WIDE if wide else {}, dtype="float32")
    ref_cfg = ref_reduced_config(ARCH).reduced(**over)
    cfg = get_reduced_config(ARCH).reduced(**over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.is_encoder_decoder and cfg.encoder_seq == 16
    return ref_cfg, cfg


def reference(wide=False):
    ref_cfg, cfg = configs(wide)
    rm = ref_build_model(ref_cfg)
    params, _ = rm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return ref_cfg, cfg, rm, params, tparams


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def _bf16_grid(a):
    return torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16).float().numpy()


def make_batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = _bf16_grid(rng.standard_normal((b, cfg.encoder_seq,
                                             cfg.d_model)))
    return ({"tokens": jnp.asarray(toks), "enc_frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks),
             "enc_frames": torch.from_numpy(frames)})


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _same_cache(tcache, cache):
    for k in ("k", "v", "cross_k", "cross_v"):
        _close(tcache[k], cache[k])
    for k in ("slot_pos", "pos"):
        np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(cache[k]))


# ---------------------------------------------------------------------------
# the layers one by one
# ---------------------------------------------------------------------------


def test_layernorm_matches_reference():
    rng = np.random.default_rng(0)
    x, s, b = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((3, 5, 64), (64,), (64,)))
    want = ref_layers.layernorm(jnp.asarray(x), jnp.asarray(s),
                                jnp.asarray(b), 1e-5)
    got = layers.layernorm(*(torch.from_numpy(a) for a in (x, s, b)), 1e-5)
    _close(got, want)
    # bf16 in, fp32 inside, one cast out
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert layers.layernorm(xb, torch.from_numpy(s), torch.from_numpy(b),
                            1e-5).dtype == torch.bfloat16


def test_gelu_mlp_matches_reference():
    _, cfg, _, params, tparams = reference()
    x = np.random.default_rng(1).standard_normal((2, 5, cfg.d_model)
                                                 ).astype(np.float32)
    ref_p = jax.tree.map(lambda a: a[0], params["enc_layers"]["mlp"])
    p = {k: v[0] for k, v in tparams["enc_layers"]["mlp"].items()}
    _close(layers.gelu_mlp(p, torch.from_numpy(x)),
           ref_layers.gelu_mlp(ref_p, jnp.asarray(x)))


@pytest.mark.parametrize("dim", [64, 128, 512])
def test_sinusoidal_pos_matches_reference(dim):
    pos = np.arange(0, 40)
    _close(layers.sinusoidal_pos(torch.from_numpy(pos), dim),
           ref_layers.sinusoidal_pos(jnp.asarray(pos), dim))


def test_cross_decode_matches_reference():
    _, cfg, _, params, tparams = reference()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, cfg.encoder_seq, cfg.num_kv_heads,
                                   cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    ref_p = jax.tree.map(lambda a: a[1], params["dec_layers"]["cross_attn"])
    p = {k: v[1] for k, v in tparams["dec_layers"]["cross_attn"].items()}
    want = ref_A.cross_decode(ref_p, cfg, jnp.asarray(x), jnp.asarray(ck),
                              jnp.asarray(cv))
    got = A.cross_decode(p, cfg, *(torch.from_numpy(a) for a in (x, ck, cv)))
    _close(got, want)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def test_params_from_numpy_bit_exact():
    """The ``enc_layers`` / ``dec_layers`` stacks and the ``*_s`` /
    ``*_b`` LayerNorm leaves carried over bit for bit, in the port's own
    init layout."""
    _, cfg, _, params, tparams = reference()
    ours = dict(_leaves(build_model(cfg).init(MetaGenerator())[0]))
    want = dict(_leaves(jax.tree.map(np.asarray, params)))
    got = dict(_leaves(tparams))
    assert sorted(got) == sorted(want) == sorted(ours)
    assert ("enc_norm_b",) in got and ("dec_layers", "ln3_s") in got
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape == tuple(ours[path].shape)
        assert np.array_equal(got[path].numpy().view(np.uint8),
                              w.view(np.uint8)), path


def test_param_count_matches_reference():
    want = ref_param_count(ref_build_model(ref_get_config(ARCH)))
    assert param_count(build_model(get_config(ARCH))) == want


def test_encode_matches_reference():
    _, cfg, _, params, tparams = reference()
    jb, tb = make_batch(cfg, 2, 4)
    _close(ED.encode(tparams, cfg, tb["enc_frames"]),
           ref_ED.encode(params, cfg, jb["enc_frames"]))


def test_forward_matches_reference():
    _, cfg, rm, params, tparams = reference()
    jb, tb = make_batch(cfg, 2, 12, 1)
    want, _ = rm.forward(params, jb)
    got, aux = build_model(cfg).forward(tparams, tb)
    _close(got, want)
    assert float(aux) == 0.0


def test_init_cache_layout_matches():
    ref_cfg, cfg = configs()
    want = ref_build_model(ref_cfg).init_cache(2, 24)
    got = build_model(cfg).init_cache(2, 24, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


def test_prefill_writes_the_cross_slabs_and_decode_reads_them():
    """Prefill: every layer's cross K/V (and the prompt's self K/V) equal
    to the reference's, written into the cache's own tensors; 3 decode
    steps against the reference leave the cross slabs as the prefill
    wrote them; and a step reads them (scaled slabs change its logits)."""
    _, cfg, rm, params, tparams = reference()
    m = build_model(cfg)
    jb, tb = make_batch(cfg, 2, 8, 3)
    cache, tcache = rm.init_cache(2, 24), m.init_cache(2, 24, "cpu")
    held = dict(tcache)
    want, cache = rm.prefill(params, jb, cache)
    got, tcache = m.prefill(tparams, tb, tcache)
    _close(got, want)
    _same_cache(tcache, cache)
    written = (tcache["cross_k"].clone(), tcache["cross_v"].clone())
    for _ in range(3):
        tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(np.int32)
        want, cache = rm.decode_step(params, cache, jnp.asarray(tok))
        got, tcache = m.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(got, want)
        _same_cache(tcache, cache)
    assert all(tcache[k] is held[k] for k in held)
    assert torch.equal(tcache["cross_k"], written[0])
    assert torch.equal(tcache["cross_v"], written[1])
    tcache["pos"].sub_(1)
    again, _ = m.decode_step(tparams, tcache, torch.from_numpy(tok))
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    tcache["pos"].sub_(1)
    tcache["cross_v"].mul_(2.0)
    moved, _ = m.decode_step(tparams, tcache, torch.from_numpy(tok))
    assert not torch.allclose(moved, got)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_batch_template_and_group_carry_the_frames():
    _, cfg = configs()
    t = batch_template(3, 8, pad=False, cfg=cfg)
    assert t["enc_frames"].shape == (3, 16, cfg.d_model)
    assert t["enc_frames"].dtype == torch.bfloat16 and "embeds" not in t
    g = make_group(cfg, 3, 8, "cpu")
    assert g["enc_frames"].shape == t["enc_frames"].shape
    assert not g["enc_frames"].any()


def test_serving_shapes_and_problems():
    """The reference's shapes; its problems, plus the encoder's rows
    bucket x encoder_seq."""
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    assert install.serving_shapes(cfg) == ref_install.serving_shapes(ref_cfg)
    _, wcfg = configs(wide=True)
    ref_wcfg = ref_reduced_config(ARCH).reduced(**WIDE, dtype="float32")
    buckets, lengths = buckets_for(4), length_buckets_for(8)
    got = {p.key() for p in install.serving_problems(wcfg, buckets, lengths)}
    want = {p.key() for p in ref_install.serving_problems(ref_wcfg, buckets,
                                                          lengths)}
    assert want < got
    assert install.prefill_rows(wcfg, buckets, lengths) == [16, 32, 64]
    assert {Problem.from_key(k).m for k in got - want} <= {16, 32, 64}


def test_ragged_admission_is_refused():
    eng = _engine()
    assert eng.model.prefill_row is None and not eng.ragged_supported()
    d = eng.model.cfg.d_model
    with pytest.raises(ValueError, match=r"ragged prompt lengths \[5, 9\] "
                       r"need an attention-cache LM \(family=encdec\)"):
        eng.serve([{"tokens": torch.arange(n, dtype=torch.int32),
                    "enc_frames": torch.zeros((16, d))} for n in (5, 9)],
                  steps=2)
    with pytest.raises(ValueError, match="continuous batching needs an "
                       "attention-cache LM"):
        ContinuousScheduler(eng)


def _engine(wide=False):
    _, cfg, _, _, tparams = reference(wide)
    axes = build_model(cfg).init(MetaGenerator())[1]
    return Engine(build_model(cfg), tparams, axes, max_len=24, max_batch=4,
                  max_prompt=8, device="cpu")


def test_install_then_serve_matches_reference_with_no_miss():
    """``install --measure`` on the CPU, then a packed engine (the tied
    head packed as a copy of the table's transpose) serves one group of
    3 (bucket 4: the frames padded with it) through its eager cells:
    0 registry misses, tokens and logits equal to the reference model's;
    every cell checks against its eager run."""
    ref_cfg, cfg, rm, params, _ = reference(wide=True)
    registry.clear_memory()
    install.install_arch(cfg, (1, 2, 4), length_buckets_for(8), measure=True,
                         iters=1, device="cpu")
    registry.flush()
    registry.clear_memory()
    registry.reset_stats()
    eng = _engine(wide=True)
    assert isinstance(eng.params["embed"]["head"], PackedTensor)
    assert "dec_layers/cross_attn/wk" in eng.pack_report
    rows = eng.precompile()
    jb, tb = make_batch(cfg, 3, 8, 4)
    res = eng.generate(tb, steps=3)
    stats = registry.stats()
    assert stats["misses"] == 0 and stats["hits"] > 0
    assert eng.programs.stats()["eager"] == len(rows)
    cache = rm.init_cache(3, 24)
    logits, cache = rm.prefill(params, jb, cache)
    for i in range(3):
        want_tok = np.argmax(np.asarray(logits)[:, -1], -1)
        np.testing.assert_array_equal(res.tokens[:, i].numpy(), want_tok)
        logits, cache = rm.decode_step(
            params, cache, jnp.asarray(want_tok[:, None], jnp.int32))
    _close(res.logits_last, logits)
    assert all(c["equal"] for c in check_cells(eng.programs))
