"""The port's train step against the reference's ``train/step.py``.

The reference's reduced configs at fp32 (and one bf16 qwen case); the
reference's params carried into the port through ``params_from_numpy``
(the hybrid's Mamba stack reshaped), never re-initialized; the same
seeded synthetic batches.  Two steps each; compared after each: the
loss (and the MoE aux), ``grad_norm``, ``lr``, every param leaf and both
moments.  The moments are the gradients' running means and squares, so
they carry the gradient parity.

The optimizer's eps is 1e-3 here, so the update is a smooth function of
the gradient: at 1e-8 an element whose gradient is near zero turns a
last-bit difference into an update of size lr (m / sqrt(v) is a sign).
``test_torch_adamw.py`` holds the update itself to the reference at the
default eps.

Tolerances, each leaf within ``atol * max|reference leaf| + rtol *
|reference|``: fp32 1e-4 / 1e-4 (torch and XLA sum in different orders
through 2 layers, forward and backward; a head of 512); the loss and
``grad_norm`` within rtol 1e-5.  bf16 compute (the masters stay fp32,
the gradients come out in bf16): every leaf within 1e-1 / 1e-1 and the
loss within 1e-2 (each side rounds its bf16 activations in different
places; the largest difference, 5.1e-2 of the leaf's largest value, is
in the zero-initialized attention biases, whose value is the update
alone).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeSpec as RefShapeSpec
from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.data.pipeline import SyntheticData as RefData
from repro.models.registry import build_model as ref_build_model
from repro.optim.adamw import OptConfig as RefOptConfig
from repro.train import step as ref_step
from repro_torch.configs.base import ShapeSpec, get_reduced_config
from repro_torch.data.pipeline import SyntheticData
from repro_torch.models.param import params_from_numpy, tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import step


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the models here are tiny, and torch's thread
    pool spins when the test workers share the cores (a 16x slower file
    under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=10, eps=1e-3)
TOL = {"float32": dict(atol=1e-4, rtol=1e-4, loss=1e-5),
       "bfloat16": dict(atol=1e-1, rtol=1e-1, loss=1e-2)}


def _leaf_close(got, want, tol, what):
    g = got.float().numpy().reshape(want.shape)
    w = np.asarray(want, np.float32)
    err = np.abs(g - w)
    bound = tol["atol"] * float(np.abs(w).max()) + tol["rtol"] * np.abs(w)
    assert np.all(err <= bound), (what, float(err.max()),
                                  float(np.abs(w).max()))


def _pair(arch, dtype="float32", **over):
    ref_cfg = dataclasses.replace(ref_reduced_config(arch), dtype=dtype,
                                  **over)
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=dtype, **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return ref_build_model(ref_cfg), build_model(cfg)


def run_both(arch, *, dtype="float32", microbatch=0, seq=32, batch=2,
             steps=2, **over):
    ref_model, model = _pair(arch, dtype, **over)
    ocfg, ref_ocfg = OptConfig(**OPT), RefOptConfig(**OPT)
    ref_state, _ = ref_step.init_train_state(ref_model, ref_ocfg,
                                             jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray,
                                            ref_state["params"]), "cpu")
    state = step.init_train_state(model, ocfg, params=params)
    ref_fn = jax.jit(ref_step.make_train_step(ref_model, ref_ocfg,
                                              microbatch=microbatch))
    fn = step.make_train_step(model, ocfg, microbatch=microbatch)
    data = RefData(ref_model.cfg, RefShapeSpec("t", seq, batch, "train"),
                   seed=7)
    tol = TOL[dtype]
    out = []
    for i in range(steps):
        b = data.batch(i)
        ref_state, ref_m = ref_fn(ref_state, b)
        state, m = fn(state, {k: torch.from_numpy(np.array(v))
                              for k, v in b.items()})
        for k in ("loss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=tol["loss"], atol=1e-7,
                                       err_msg=f"{arch} step {i} {k}")
        for key in ("params", "opt"):
            for n, (a, w) in enumerate(zip(tree_leaves(state[key]),
                                           jax.tree.leaves(ref_state[key]))):
                _leaf_close(a, w, tol, (arch, i, key, n))
        assert int(state["step"]) == int(ref_state["step"]) == i + 1
        out.append(m)
    return state, out


def test_cross_entropy_masks_ignored_labels():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, :2] = -100
    labels[1, 4] = -100
    got = step.cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(labels))
    want = ref_step.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # every label ignored: the denominator is 1, the loss 0
    none = torch.full((2, 5), -100, dtype=torch.int32)
    assert float(step.cross_entropy(torch.from_numpy(logits), none)) == 0.0
    bf = torch.from_numpy(logits).to(torch.bfloat16)
    assert step.cross_entropy(bf, torch.from_numpy(labels)).dtype == \
        torch.float32


@pytest.mark.parametrize("arch,microbatch,batch", [
    ("qwen1_5_4b", 1, 2),          # dense
    ("qwen1_5_4b", 2, 4),          # dense, two accumulated micro-slices
    ("olmoe_1b_7b", 1, 2),         # MoE: the aux loss in the objective
    ("mamba2_780m", 1, 2),         # SSM
    ("zamba2_2_7b", 1, 2),         # hybrid: Mamba stack (L,) vs (G, P)
    ("llava_next_mistral_7b", 1, 2),   # VLM: image embeddings, -100 labels
    ("whisper_base", 1, 2),        # encoder-decoder
])
def test_two_steps_match_the_reference_fp32(arch, microbatch, batch):
    seq = 24 if arch == "llava_next_mistral_7b" else 32
    _, ms = run_both(arch, microbatch=microbatch, batch=batch, seq=seq)
    if arch == "olmoe_1b_7b":
        assert all(float(m["aux"]) > 0 for m in ms)


def test_microbatch_falls_back_when_the_batch_does_not_divide():
    """3 rows, 2 micro-slices asked: one slice of 3, as the reference."""
    run_both("qwen1_5_4b", microbatch=2, batch=3, steps=1)


def test_two_steps_match_the_reference_bf16():
    state, _ = run_both("qwen1_5_4b", dtype="bfloat16")
    # fp32 masters of every leaf, bf16 compute
    assert all(t.dtype == torch.float32
               for t in tree_leaves(state["params"]))


def test_compute_copy_casts_matrices_only():
    cfg = dataclasses.replace(get_reduced_config("qwen1_5_4b"),
                              dtype="bfloat16")
    params = {"w": torch.ones(4, 4), "b": torch.ones(4),
              "i": torch.ones(2, 2, dtype=torch.int32)}
    got = step.cast_params_for_compute(params, cfg)
    assert got["w"].dtype == torch.bfloat16
    assert got["b"].dtype == torch.float32
    assert got["i"].dtype == torch.int32
    f32 = step.cast_params_for_compute(
        params, dataclasses.replace(cfg, dtype="float32"))
    assert f32["w"] is params["w"]


@pytest.mark.parametrize("arch", ["qwen1_5_4b", "zamba2_2_7b",
                                  "whisper_base"])
def test_remat_leaves_the_step_unchanged(arch):
    """Remat on (each layer body under ``torch.utils.checkpoint``) and off
    give bit-equal states and metrics on the CPU."""
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    assert cfg.remat
    states = []
    for remat in (True, False):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        ocfg = OptConfig(**OPT)
        state = step.init_train_state(
            model, ocfg, generator=torch.Generator().manual_seed(0))
        data = SyntheticData(model.cfg, ShapeSpec("t", 32, 2, "train"),
                             seed=3, device="cpu")
        state, m = step.make_train_step(model, ocfg)(state, data.batch(0))
        states.append((state, m))
    (a, ma), (b, mb) = states
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_remat_wraps_the_layer_bodies(monkeypatch):
    """Under training each scanned layer body goes through
    ``torch.utils.checkpoint``; under ``no_grad`` (and serving's
    ``inference_mode``) none does."""
    import torch.utils.checkpoint as ckpt
    calls = []
    real = ckpt.checkpoint

    def counting(fn, *a, **k):
        calls.append(fn.__name__)
        return real(fn, *a, **k)

    monkeypatch.setattr(ckpt, "checkpoint", counting)
    cases = {"qwen1_5_4b": ["_layer_fwd"] * 2,
             "deepseek_v2_236b": ["_layer_fwd"],     # dense0 is not
             "zamba2_2_7b": ["mamba_fwd"] * 4,
             "whisper_base": ["_enc_layer_fwd"] * 2 + ["_dec_layer_fwd"] * 2}
    for arch, want in cases.items():
        cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))[0]
        batch = SyntheticData(cfg, ShapeSpec("t", 16, 1, "train"),
                              device="cpu").batch(0)
        with torch.no_grad():
            model.forward(params, batch)
        assert calls == [], arch
        for t in tree_leaves(params):
            t.requires_grad_(True)
        logits, _ = model.forward(params, batch)
        assert calls == want, (arch, calls)
        logits.float().sum().backward()
        calls.clear()


# ---------------------------------------------------------------------------
# the flash gate: closed to any call autograd records
# ---------------------------------------------------------------------------


def _gate(q, k, v):
    from repro_torch.models import attention as A
    return A.flash_eligible(q, k, v, window=0, q_offset=0, k_offset=0,
                            valid_from=None)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_gate_closes_when_autograd_records(monkeypatch, which):
    """With the device check stubbed to the card's (a predicate read on
    the CPU), a q, k or v that requires grad under grad mode closes the
    gate; under ``no_grad`` or ``inference_mode`` it is as before."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    qkv = {n: torch.zeros((1, 256, 2, 128)) for n in "qkv"}
    assert _gate(*qkv.values())
    qkv[which].requires_grad_(True)
    with torch.enable_grad():
        assert not _gate(*qkv.values())
    with torch.no_grad():
        assert _gate(*qkv.values())
    with torch.inference_mode():
        assert _gate(*(t.detach() for t in qkv.values()))


def test_training_attention_takes_the_chunked_body(monkeypatch):
    """Under autograd the attention never reaches the flash wrapper (its
    output has no ``grad_fn``), so gradients reach q, k and v."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.models import attention as A
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))

    def refuse(*a, **k):
        raise AssertionError("flash reached under autograd")

    monkeypatch.setattr(F, "flash_attention", refuse)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 256, 2, 64), generator=g).requires_grad_()
               for _ in range(3))
    out = A.chunked_attention(q, k, v, causal=True)
    out.square().sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in (q, k, v))
    with torch.inference_mode(), pytest.raises(AssertionError,
                                               match="flash reached"):
        A.chunked_attention(q.detach(), k.detach(), v.detach())
