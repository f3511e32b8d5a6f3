"""The port's MoE layer (``models/moe.py``) against the reference's.

The same params (the reference's ``init_moe``, cast to float32, carried
across through numpy) and the same inputs (seeded numpy) go through
``moe_apply`` in both packages, for both reduced MoE configs.
Tolerances: outputs within rtol = atol = 1e-5 (float32, the k expert
contributions of a token added in the same order, the GEMMs' fp32 sums
in another); aux within 1e-6; which tokens drop, and every capacity,
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.models import moe as ref_moe
from repro_torch.configs.base import get_reduced_config
from repro_torch.models import moe
from repro_torch.models.param import params_from_numpy

ARCHS = ("olmoe_1b_7b", "deepseek_v2_236b")
TOL = 1e-5


def _setup(arch, shape, seed=1):
    ref_cfg, cfg = ref_reduced_config(arch), get_reduced_config(arch)
    p, _ = ref_moe.init_moe(jax.random.PRNGKey(0), ref_cfg)
    p = jax.tree.map(lambda v: np.asarray(v, np.float32), p)
    x = (0.5 * np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model))).astype(np.float32)
    return ref_cfg, cfg, p, x


def _run(arch, shape, factor):
    ref_cfg, cfg, p, x = _setup(arch, shape)
    want, want_aux = ref_moe.moe_apply(p, ref_cfg, jnp.asarray(x),
                                       capacity_factor=factor)
    got, aux = moe.moe_apply(params_from_numpy(p, "cpu"), cfg,
                             torch.from_numpy(x), capacity_factor=factor)
    return np.asarray(want), float(want_aux), got.numpy(), float(aux), p, x, cfg


def _dropped(p, cfg, x, factor):
    """Which (token, choice) entries the reference's dispatch drops, from
    its own routing (the rank of each entry within its expert)."""
    t = x.shape[0] * x.shape[1]
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = x.reshape(t, -1) @ p["router"]
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    flat = np.asarray(top_e).reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(t * k) - np.searchsorted(flat[order],
                                                     flat[order], "left")
    return rank >= ref_moe._capacity(t, e, k, factor)


@pytest.mark.parametrize("arch", ARCHS)
def test_drop_free_matches_reference(arch):
    want, want_aux, got, aux, _, _, _ = _run(arch, (2, 8), 8.0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert abs(aux - want_aux) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [0.25, 1.25])
def test_with_drops_matches_reference(arch, factor):
    """At (2, 32) tokens; at 0.25 the reduced configs' capacity is 8
    against 16 entries an expert on average, so entries drop.  The same
    entries drop in both (an entry the port kept and the reference
    dropped would change the token's output by a whole expert)."""
    want, want_aux, got, aux, p, x, cfg = _run(arch, (2, 32), factor)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert abs(aux - want_aux) <= 1e-6
    dropped = _dropped(p, cfg, x, factor)
    if factor == 0.25:
        assert dropped.any()
    # the dropped entries' tokens: a drop-free run differs there, and only
    # there
    free = _run(arch, (2, 32), 8.0)[2].reshape(64, -1)
    hit = dropped.reshape(64, -1).any(-1)
    moved = np.abs(free - got.reshape(64, -1)).max(-1) > TOL
    np.testing.assert_array_equal(moved, hit)


@pytest.mark.parametrize("tokens", [1, 4, 64, 1000, 4096])
@pytest.mark.parametrize("e,k", [(8, 2), (64, 8), (160, 6)])
@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 8.0])
def test_capacity_equals_reference(tokens, e, k, factor):
    assert moe._capacity(tokens, e, k, factor) == ref_moe._capacity(
        tokens, e, k, factor)


def test_combine_adds_in_expert_order():
    """bf16, 6 of 8 experts a token: each token's output is its weighted
    expert outputs added one after the other in expert-id order, the
    order that makes the combine's bits a function of the routing alone
    (the card test checks those bits across calls and graph replays).
    The expert outputs are recomputed with ``moe_apply``'s own products;
    the reversed order gives other bits, so the order is what is held."""
    import dataclasses

    from repro_torch.models.layers import silu
    cfg = dataclasses.replace(get_reduced_config("olmoe_1b_7b"),
                              experts_per_token=6)
    p, _ = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    p = {k: (v if k == "router" else v.to(torch.bfloat16))
         for k, v in p.items()}
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    got = moe.moe_apply(p, cfg, x, capacity_factor=8.0)[0]
    t, d = 32, cfg.d_model
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = moe._capacity(t, e, k, 8.0)
    xf = x.reshape(t, d)
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    order = torch.argsort(top_e.reshape(-1), stable=True)
    e_sorted = top_e.reshape(-1)[order]
    rank = torch.arange(t * k) - torch.searchsorted(e_sorted, e_sorted)
    assert bool((rank < cap).all())                       # drop-free
    slot = e_sorted * cap + rank
    buf = xf.new_zeros((e * cap, d)).index_copy_(0, slot, xf[order // k])
    buf = buf.view(e, cap, d)
    h = silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    y = torch.bmm(h, p["w_down"]).reshape(e * cap, d)
    at = torch.empty_like(order).scatter_(0, order, torch.arange(t * k))

    def combine(descending):
        rows = []
        for i in range(t):
            acc = None
            for j in sorted(range(k), key=lambda j: int(top_e[i, j]),
                            reverse=descending):
                c = y[slot[at[i * k + j]]] * top_p[i, j].to(torch.bfloat16)
                acc = c if acc is None else acc + c
            rows.append(acc)
        return torch.stack(rows).reshape(got.shape)

    assert torch.equal(got, combine(False))
    assert not torch.equal(got, combine(True))


def test_router_is_float32_and_experts_stack():
    cfg = get_reduced_config("deepseek_v2_236b")
    p, axes = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].shape == (cfg.num_experts, cfg.d_model,
                                 cfg.d_ff_expert)
    assert axes["w_down"] == ("experts", "mlp", "embed")
    assert p["ws_gate"].shape == (cfg.d_model, cfg.d_ff_expert
                                  * cfg.num_shared_experts)
