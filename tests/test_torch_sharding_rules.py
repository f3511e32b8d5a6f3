"""The port's sharding rules against the reference's, on abstract meshes.

Every leaf of all ten configs' params at their published sizes (the
reference's ``jax.eval_shape`` of its init: no allocation), on meshes
(2,), (4,), (2, 2), (4, 2), (16, 16) and (2, 16, 16), under the default
options, ``fsdp``, ``serve_2d_tp`` and ``sequence_parallel`` True and
"model": ``param_pspecs`` (``pspec_for``), ``_packed_pspec`` of each
leaf packed at 128 x 128 blocks, ``cache_pspecs`` of a decode cache,
``batch_pspec`` and ``tokens_pspec`` at several batches and lengths,
and the per-shard serving problems the sweep plans
(``sharded_serving_shapes``; the reference's walk over the same shapes,
the reference function itself on the model=2 mesh).  The reference runs
on ``jax.sharding.AbstractMesh`` (no devices), the port on its
``sharding/rules.py::Mesh``; specs must be equal entry for entry.  Then
the cases of the reference's ``test_serve_2d_tp_spec_logic`` on the
port's ``ShardCtx``.
"""

import functools
import types

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.core.install import sharded_serving_shapes as ref_sharded_shapes
from repro.models.param import is_axes_leaf
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import iter_packable as ref_iter_packable
from repro.sharding import context as ref_context
from repro.sharding import rules as ref_rules
from repro_torch.configs.base import get_config
from repro_torch.core.install import sharded_serving_shapes
from repro_torch.models.param import MetaGenerator
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import iter_packable, tied_head
from repro_torch.sharding import context, rules

MESHES = {
    "2": ((2,), ("model",)),
    "4": ((4,), ("model",)),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
OPTS = {
    "default": {},
    "fsdp": {"fsdp": True},
    "serve_2d_tp": {"serve_2d_tp": True},
    "sp": {"sequence_parallel": True},
    "sp_model": {"sequence_parallel": "model"},
}
BATCHES = (1, 2, 3, 8, 32, 128, 256)
SEQS = (1, 4096)


@functools.lru_cache(maxsize=None)
def ref_tree(arch: str):
    """The reference's params (shape structs) and axes at full size, and
    a decode cache's shape structs."""
    cfg = ref_get_config(arch)
    model = ref_build_model(cfg)
    captured = {}

    def init(rng):
        params, axes = model.init(rng)
        captured["axes"] = axes
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.init_cache(8, 4096))
    return cfg, shapes, captured["axes"], cache


@functools.lru_cache(maxsize=None)
def port_tree(arch: str):
    """The port's params on the ``meta`` device, its axes, and the leaf
    paths only the port packs: a tied model's head (``tied_head``) and
    the hybrid's Mamba stack, 3-D in the port, (groups, per_group, k, n)
    in the reference, whose rule skips 4-D leaves."""
    cfg = get_config(arch)
    shapes, axes = tied_head(*build_model(cfg).init(MetaGenerator()))
    port_only = {"embed/head"} if cfg.tie_embeddings else set()
    return cfg, shapes, axes, port_only


def ref_opts(mesh_key, opt_key):
    kw = dict(OPTS[opt_key])
    if mesh_key == "2x16x16":
        kw.update(dp_axes=("pod", "data"), fsdp_axes=("pod", "data"))
    return ref_rules.ShardingOptions(**kw), rules.ShardingOptions(**kw)


def spec(x) -> tuple:
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in x)


def leaves(axes, shapes, path=()):
    if is_axes_leaf(axes):
        yield path, axes, shapes
        return
    for k in axes:
        yield from leaves(axes[k], shapes[k], path + (k,))


def packed_stub(shape):
    lead, (r, c) = tuple(shape[:-2]), tuple(shape[-2:])
    return types.SimpleNamespace(blocks=types.SimpleNamespace(
        shape=(*lead, -(-r // 128), -(-c // 128), 128, 128)))


def outcome(fn):
    """``fn()``'s value, or the type of what it raised: where the
    reference's rules raise (FSDP on a mesh without a data axis), the
    port's must raise the same."""
    try:
        return fn()
    except Exception as e:              # noqa: BLE001 - compared below
        return type(e)


def spec_tree(axes, specs):
    if isinstance(specs, type):
        return specs
    return {p: spec(s) for p, _, s in leaves(axes, specs)}


@pytest.mark.parametrize("opt_key", list(OPTS))
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_equal_the_reference(arch, mesh_key, opt_key):
    shape, names = MESHES[mesh_key]
    ref_mesh = AbstractMesh(shape, names)
    mesh = rules.Mesh.of(shape, names)
    ropts, opts = ref_opts(mesh_key, opt_key)
    cfg, shapes, axes, cache = ref_tree(arch)

    # every param leaf, and the same leaf packed
    ref_specs = spec_tree(axes, outcome(
        lambda: ref_rules.param_pspecs(axes, shapes, ref_mesh, ropts)))
    port_specs = spec_tree(axes, outcome(
        lambda: rules.param_pspecs(axes, shapes, mesh, opts)))
    assert port_specs == ref_specs
    for path, ax, leaf in leaves(axes, shapes):
        if len(leaf.shape) in (2, 3):
            stub = packed_stub(leaf.shape)
            got = outcome(lambda: spec(rules._packed_pspec(ax, stub, mesh,
                                                           opts)))
            want = outcome(lambda: spec(ref_rules._packed_pspec(
                ax, stub, ref_mesh, ropts)))
            assert got == want, path

    # the decode cache
    assert outcome(lambda: {k: spec(v) for k, v in rules.cache_pspecs(
        cfg, cache, mesh, opts).items()}) == outcome(
        lambda: {k: spec(v) for k, v in ref_rules.cache_pspecs(
            cfg, cache, ref_mesh, ropts).items()})

    # activations (sequence parallelism on a mesh without a data axis
    # raises in both)
    for b in BATCHES:
        assert spec(rules.batch_pspec(b, mesh, opts)) == spec(
            ref_rules.batch_pspec(b, ref_mesh, ropts)), b
        for s in SEQS:
            assert outcome(lambda: spec(rules.tokens_pspec(
                b, s, mesh, opts))) == outcome(lambda: spec(
                    ref_rules.tokens_pspec(b, s, ref_mesh, ropts))), (b, s)

    # the per-shard problems the sweep plans: the reference's walk over
    # the same shapes (its own function where it is cheap enough: model=2
    # under the defaults), the port's over its own tree
    ref_set = outcome(lambda: {
        (r // rs, c // cs, rs * cs) for _, _, (r, c, rs, cs) in
        ref_iter_packable(shapes, axes, ref_mesh, ropts)
        if not (r % rs or c % cs)})
    if (mesh_key, opt_key) == ("2", "default"):
        assert ref_sharded_shapes(cfg, ref_mesh, ropts) == ref_set
        want = ref_set
        gn = cfg.ssm_groups * cfg.ssm_state
        half = (cfg.d_model, (2 * cfg.d_inner + 2 * gn + cfg.ssm_heads) // 2,
                2)
        if cfg.ssm_state and half in want:
            # the SSM in-projection's piece is its segments' width (the
            # rank's heads of z, x and dt and the whole B and C:
            # models/mamba2.py::tp_segments), not the contiguous half (the
            # hybrid's 4-D Mamba stack is not in the reference's walk)
            want = (want - {half}) | {
                (cfg.d_model, cfg.d_inner + 2 * gn + cfg.ssm_heads // 2, 2)}
        assert sharded_serving_shapes(get_config(arch), mesh, opts) >= want
    pcfg, pshapes, paxes, port_only = port_tree(arch)

    def port_sets():
        common, extra = set(), set()
        for path, _, (r, c, rs, cs) in iter_packable(pshapes, paxes, mesh,
                                                     opts):
            if r % rs or c % cs:
                continue
            key = "/".join(path)
            own = key in port_only or (pcfg.family == "hybrid"
                                       and key.startswith("mamba_layers/"))
            (extra if own else common).add((r // rs, c // cs, rs * cs))
        return common, extra

    got = outcome(port_sets)
    if isinstance(ref_set, type):
        assert got is ref_set
    else:
        assert got[0] == ref_set


def test_qwen_per_shard_problems_at_model_2():
    """The five per-shard problems of qwen1.5-4b at model=2, equal to the
    reference's."""
    ref = ref_sharded_shapes(ref_get_config("qwen1_5_4b"),
                             AbstractMesh((2,), ("model",)),
                             ref_rules.ShardingOptions())
    got = sharded_serving_shapes(get_config("qwen1_5_4b"),
                                 rules.Mesh.of((2,), ("model",)))
    assert got == ref == {(1280, 2560, 2), (2560, 1280, 2), (2560, 3456, 2),
                          (2560, 75968, 2), (3456, 2560, 2)}


SPEC_CASES = [
    # (serve_2d_tp, names, shape, the reference test's expectation or None)
    (False, ("batch", None), (128, 512), ("data", None)),
    (True, ("batch", None), (128, 512), (None, None)),
    (False, ("batch", "kblocks", None), (128, 16, 64), ("data", None, None)),
    (True, ("batch", "kblocks", None), (128, 16, 64), (None, "data", None)),
    (True, ("layers", "cache_batch", "cache_seq", "kvheads", "headdim"),
     (4, 128, 4096, 8, 128), None),
    (False, ("layers", "cache_batch", "cache_seq", "kvheads", "headdim"),
     (4, 1, 4096, 2, 128), None),
    (False, ("batch", "seq", "heads", None), (3, 4096, 32, 128), None),
    (True, ("batch", "seq", "vocab"), (8, 1, 151936), None),
]


@pytest.mark.parametrize("case", range(len(SPEC_CASES)))
def test_serve_2d_tp_spec_logic(case):
    """The reference's ``test_serve_2d_tp_spec_logic`` cases on the port's
    ShardCtx (a 4 x 4 data x model mesh), and the reference's ShardCtx on
    the same abstract mesh."""
    tp2d, names, shape, want = SPEC_CASES[case]
    mesh = rules.Mesh.of((4, 4), ("data", "model"))
    ref_mesh = AbstractMesh((4, 4), ("data", "model"))
    got = context.ShardCtx(mesh, rules.ShardingOptions(serve_2d_tp=tp2d)
                           ).spec_for(names, shape)
    ref = ref_context.ShardCtx(ref_mesh, ref_rules.ShardingOptions(
        serve_2d_tp=tp2d)).spec_for(names, shape)
    assert spec(got) == spec(ref)
    if want is not None:
        assert spec(got) == want
    if names[1] == "cache_batch" and tp2d:
        assert got[1] == "data"       # caches keep dp batch sharding


def test_local_shard_cuts_the_piece_of_a_spec():
    import numpy as np
    mesh = rules.Mesh.of((2, 2), ("data", "model"))
    x = np.arange(4 * 8 * 6).reshape(4, 8, 6)
    spec_ = rules.P(None, ("data", "model"), "model")
    pieces = {}
    for d in range(2):
        for m in range(2):
            got = rules.local_shard(x, spec_, mesh, {"data": d, "model": m})
            assert got.shape == rules.local_shape(x.shape, spec_, mesh)
            pieces[(d, m)] = got
    # the first of a tuple of axes is the major one
    np.testing.assert_array_equal(pieces[(0, 1)], x[:, 2:4, 3:6])
    np.testing.assert_array_equal(pieces[(1, 0)], x[:, 4:6, 0:3])


def test_production_and_test_meshes_are_shapes():
    from repro_torch.launch.mesh import (make_production_mesh,
                                         make_test_mesh)
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).axis_names == (
        "pod", "data", "model")
    assert make_test_mesh().size == 4
