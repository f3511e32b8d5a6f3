"""The SSM family and the hybrid under tensor parallelism (gloo, CPU)
against the reference.

Reduced Mamba2-780m and Zamba2-2.7B, widened to d_model 512 so every
Mamba leaf, the shared block's projections and the head pack, fp32.  The
parent builds the reference's params and serves them on the reference's
single-device ``Engine``; for each mesh one spawn of ranks over a file
store serves both archs on ``Engine(mesh=)`` from their pieces
(``params_from_numpy``'s sharded form) after ``install --mesh``:

* ``model=2``: each rank its Mamba2 heads (``w_in`` and the conv cut by
  segments: the rank's heads of ``z`` / ``x`` / ``dt`` and the whole
  ``B`` / ``C``), the shared block's heads and MLP columns, half the
  vocabulary;
* ``data=2,model=2`` over 4 ranks: bucket 2 splits its rows over
  ``data``; bucket 1 is computed whole on every rank (the hybrid's K/V
  slots split over ``data``, the softmax combined over them).

Checks: tokens equal and logits within ``F32_TOL`` (1e-4 + 1e-4 |ref|),
0 registry misses, the packed pieces equal to ``sharded_serving_shapes``,
the conv cache's segmented width, one decode call's collectives equal to
the contract from the shapes; on ``model=2`` each rank's columns of
``w_in`` / ``conv_w`` / ``conv_b`` equal to the reference's columns of
its heads, ``init_pieces`` equal to a whole init cut the same way, and
``mamba2_forward`` / ``mamba2_decode`` on the rank's pieces against the
reference's on the whole block.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.core import registry as ref_registry
from repro.models import mamba2 as ref_M
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import Engine as RefEngine
from repro_torch.configs.base import get_reduced_config

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("mamba2_780m", "zamba2_2_7b")
WIDE = {
    "mamba2_780m": dict(d_model=512, num_heads=0, num_kv_heads=0, d_ff=0),
    "zamba2_2_7b": dict(d_model=512, num_heads=4, num_kv_heads=4,
                        head_dim=128, d_ff=1024),
}
F32_TOL = 1e-4
TIMEOUT = 300
GROUPS = ((1, 16, 3), (2, 16, 4))      # batch, prompt, seed
STEPS = 3
MAX_LEN = 32
BUCKETS = (1, 2)
MODULE_X = (2, 16)                     # the module check's (rows, tokens)
# spec -> world
MESHES = {"model=2": 2, "data=2,model=2": 4}


def cfg_pair(arch: str):
    over = dict(WIDE[arch], dtype="float32")
    return (ref_reduced_config(arch).reduced(**over),
            get_reduced_config(arch).reduced(**over))


def prompt(cfg, b: int, plen: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, plen)).astype(np.int32)


def module_x(d: int) -> tuple:
    rng = np.random.default_rng(21)
    return (rng.standard_normal((*MODULE_X, d)).astype(np.float32),
            rng.standard_normal((MODULE_X[0], 1, d)).astype(np.float32))


WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core import registry
    from repro_torch.core.install import (install_arch, parse_mesh,
                                          sharded_serving_shapes)
    from repro_torch.core.packing import is_packed
    from repro_torch.core.plan import length_buckets_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mamba2 as M
    from repro_torch.models.lm import layer_params
    from repro_torch.models.param import (MetaGenerator, init_pieces,
                                          params_from_numpy)
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding.context import sharding_ctx
    from repro_torch.sharding.rules import (ShardingOptions, local_params,
                                            param_pspecs)

    rank, world, out, spec = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    cfg_in = json.load(open(os.path.join(out, "cfg.json")))
    buckets = tuple(cfg_in["buckets"])
    desc = parse_mesh(spec)
    mesh = make_mesh(tuple(desc.shape.values()), desc.axis_names,
                     device="cpu", rank=rank, world_size=world,
                     init_file=os.path.join(out, "store"), verbose=False)
    torch.set_num_threads(1)
    res, arrays = {}, {}

    def tree_of(path):
        flat = np.load(path)
        tree = {}
        for key in flat.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
        return tree

    def leaves(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, t

    for arch in cfg_in["archs"]:
        cfg = get_reduced_config(arch).reduced(**cfg_in["over"][arch])
        install_arch(cfg, buckets, length_buckets_for(16), mesh=desc,
                     device="cpu")
        registry.flush()
        misses0 = registry.stats()["misses"]
        model = build_model(cfg)
        axes = model.init(MetaGenerator())[1]
        params = params_from_numpy(tree_of(os.path.join(
            out, f"params_{arch}.npz")), "cpu", mesh=mesh, axes=axes,
            cfg=cfg)
        stack = params["layers" if cfg.family == "ssm" else "mamba_layers"]
        p0 = layer_params(stack, 0)["mamba"]
        r = {}
        if cfg_in["module"]:
            for name in ("w_in", "conv_w", "conv_b"):
                arrays[f"{arch}_{name}"] = p0[name].numpy()
            # a seeded init cut as it is drawn holds what a whole init
            # cut by the same segments holds
            with init_pieces(mesh, cfg):
                pieces = model.init(torch.Generator().manual_seed(5))[0]
            whole = model.init(torch.Generator().manual_seed(5))[0]

            def cut(path, spec, shape):
                a = axes
                for key in path:
                    a = a[key]
                return M.leaf_segments(cfg, a, shape, spec, mesh,
                                       mesh.coords)

            got = local_params(whole, param_pspecs(
                axes, whole, mesh, ShardingOptions()), whole, mesh, cut=cut)
            r["init_pieces_equal"] = all(
                torch.equal(a, b) for (_, a), (_, b) in
                zip(sorted(leaves(pieces)), sorted(leaves(got))))
            x, x2 = (torch.from_numpy(a) for a in np.load(
                os.path.join(out, "module_x.npz")).values())
            with torch.inference_mode(), sharding_ctx(mesh):
                y, (h, tail) = M.mamba2_forward(p0, cfg, x)
                yd, ssm, conv = M.mamba2_decode(p0, cfg, x2, h, tail)
            for k, v in (("y", y), ("h", h), ("tail", tail), ("yd", yd),
                         ("ssm", ssm), ("conv", conv)):
                arrays[f"{arch}_mod_{k}"] = v.numpy()
        eng = Engine(model, params, axes, max_len=cfg_in["max_len"],
                     buckets=buckets, max_prompt=16, device="cpu", mesh=mesh)
        r["packed"] = sorted(eng.pack_report)
        r["pieces"] = sorted({tuple(t.shape[-2:]) for _, t in
                              leaves(eng.params) if is_packed(t)})
        r["shapes"] = sorted((k, n) for k, n, _ in
                             sharded_serving_shapes(cfg, desc))
        r["conv"] = {str(b): list(eng.programs.static_cache(
            b, cfg_in["max_len"])["conv"].shape) for b in buckets}
        r["layouts"] = {str(b): repr(eng.cache_layout(b)) for b in buckets}
        for b, plen, seed in cfg_in["groups"]:
            toks = np.load(os.path.join(out, f"toks_{arch}_{b}.npy"))
            got = eng.generate({"tokens": torch.from_numpy(toks)},
                               cfg_in["steps"])
            arrays[f"{arch}_tokens_{b}"] = got.tokens.numpy()
            arrays[f"{arch}_logits_{b}"] = got.logits_last.numpy()
            r[f"buckets_{b}"] = list(got.buckets)
            r[f"decode_{b}"] = eng.collectives("decode", got.buckets[0])
        r["misses"] = registry.stats()["misses"] - misses0
        r["healthy"] = eng.health_report()["healthy"]
        res[arch] = r
        del eng, params
    np.savez(os.path.join(out, f"out_{rank}.npz"), **arrays)
    json.dump(res, open(os.path.join(out, f"res_{rank}.json"), "w"))
    mesh.close()
""")


def flat_params(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_params(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


_REFS: dict = {}


@pytest.fixture(scope="module")
def ref_env(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PLAN_CACHE",
              str(tmp_path_factory.mktemp("ref_plans") / "plans.json"))
    ref_registry.clear_memory()
    yield
    mp.undo()
    ref_registry.clear_memory()
    _REFS.clear()


def reference(arch: str) -> tuple:
    """The reference's params, its single-device Engine's groups, and its
    Mamba2 block (the first layer) forward and one decode step on
    ``module_x``."""
    if arch in _REFS:
        return _REFS[arch]
    ref_cfg, cfg = cfg_pair(arch)
    model = ref_build_model(ref_cfg)
    params, axes = model.init(jax.random.PRNGKey(0))
    eng = RefEngine(model, params, axes, max_len=MAX_LEN,
                    max_batch=max(BUCKETS), max_prompt=16,
                    program_cache=False)
    want = {}
    for b, plen, seed in GROUPS:
        toks = prompt(cfg, b, plen, seed)
        want[f"toks_{b}"] = toks
        r = eng.generate({"tokens": jnp.asarray(toks)}, STEPS)
        want[f"tokens_{b}"] = np.asarray(r.tokens)
        want[f"logits_{b}"] = np.asarray(r.logits_last)
    stack = params["layers"] if cfg.family == "ssm" else jax.tree.map(
        lambda a: a[0], params["mamba_layers"])
    p0 = jax.tree.map(lambda a: a[0], stack["mamba"])
    x, x2 = module_x(cfg.d_model)
    y, (h, tail) = ref_M.mamba2_forward(p0, ref_cfg, jnp.asarray(x))
    yd, ssm, conv = ref_M.mamba2_decode(p0, ref_cfg, jnp.asarray(x2), h,
                                        tail, 0)
    want["mod"] = {k: np.asarray(v) for k, v in (
        ("y", y), ("h", h), ("tail", tail), ("yd", yd), ("ssm", ssm),
        ("conv", conv))}
    want["p0"] = {k: np.asarray(v) for k, v in p0.items()}
    want["flat"] = flat_params(jax.tree.map(np.asarray, params))
    _REFS[arch] = (cfg, want)
    return _REFS[arch]


def spawn(tmp_path: Path, spec: str, world: int) -> list:
    over = {}
    for arch in ARCHS:
        cfg, want = reference(arch)
        np.savez(tmp_path / f"params_{arch}.npz", **want["flat"])
        for b, _, _ in GROUPS:
            np.save(tmp_path / f"toks_{arch}_{b}.npy", want[f"toks_{b}"])
        over[arch] = dict(WIDE[arch], dtype="float32")
    np.savez(tmp_path / "module_x.npz", *module_x(512))
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"archs": ARCHS, "over": over, "buckets": BUCKETS, "groups": GROUPS,
         "steps": STEPS, "max_len": MAX_LEN, "module": world == 2}))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   REPRO_TORCH_PLAN_CACHE=str(tmp_path / f"plans{r}.json"),
                   REPRO_TORCH_MEASURE_CACHE=str(tmp_path / f"meas{r}.json"),
                   REPRO_TORCH_MISS_LOG=str(tmp_path / f"miss{r}.json"),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(r), str(world), str(tmp_path),
             spec], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not errs, errs
    return [(np.load(tmp_path / f"out_{r}.npz"),
             json.loads((tmp_path / f"res_{r}.json").read_text()))
            for r in range(world)]


def segments(cfg, rank: int, width: int) -> np.ndarray:
    """The reference's column indices of rank ``rank``'s heads in an
    ``ssm_inner`` axis of ``width`` at tp 2, built from the layout
    ``[z | x | B | C | dt]`` (or ``[x | B | C]``) directly."""
    di, h = cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    half, hh = di // 2, h // 2
    x = np.arange(rank * half, (rank + 1) * half)
    bc = np.arange(2 * gn)
    if width == di + 2 * gn:
        return np.concatenate([x, di + bc])
    return np.concatenate([x, di + x, 2 * di + bc,
                           2 * di + 2 * gn + np.arange(rank * hh,
                                                       (rank + 1) * hh)])


def decode_contract(cfg, rows: int) -> dict:
    """One decode call's collectives on a rank computing ``rows`` rows,
    fp32, every group of 2 ranks: the lookup's all-reduce; per Mamba2
    layer the gated norm's (rows, 1) sum of squares and ``w_out``'s
    (rows, 1, d) partials all-reduced; per application of the hybrid's
    shared block ``wo``'s and ``w_down``'s all-reduce, and where its K/V
    slots are split over the data axis (a whole bucket on a data mesh),
    the softmax partials' all-gather; the logits' all-gather."""
    d, f = cfg.d_model, 4
    ar, ag = [rows * d * f], [rows * cfg.vocab_size * f]
    for _ in range(cfg.num_layers):
        ar += [rows * f, rows * d * f]
    if cfg.family == "hybrid":
        for _ in range(cfg.num_layers // cfg.attn_every):
            ar += [rows * d * f, rows * d * f]
    return {"all-reduce": {"count": len(ar), "bytes_moved": float(sum(ar)),
                           "tensor_bytes": float(sum(ar))},
            "all-gather": {"count": len(ag),
                           "bytes_moved": float(sum(ag)) / 2,
                           "tensor_bytes": float(sum(ag))}}


def seq_split_gathers(cfg, rows: int) -> dict:
    """The hybrid's split-softmax all-gathers over ``data`` (2 ranks) at a
    whole bucket: per application every local head's (m, l, acc)."""
    n = cfg.num_layers // cfg.attn_every
    kh = cfg.num_kv_heads // 2
    g = cfg.num_heads // cfg.num_kv_heads
    one = 2 * rows * kh * g * (2 + cfg.head_dim) * 4
    return {"count": n, "bytes_moved": float(n * one) / 2,
            "tensor_bytes": float(n * one)}


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.abs(got - want) <= F32_TOL + F32_TOL * np.abs(want)), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("spec", list(MESHES))
def test_ssm_tp_engine_matches_the_reference(ref_env, tmp_path, spec):
    world = MESHES[spec]
    ranks = spawn(tmp_path, spec, world)
    dp = world // 2
    for arch in ARCHS:
        cfg, want = reference(arch)
        di, h = cfg.d_inner, cfg.ssm_heads
        gn = cfg.ssm_groups * cfg.ssm_state
        for rank, (out, allres) in enumerate(ranks):
            res = allres[arch]
            assert res["misses"] == 0 and res["healthy"], res
            # the packed pieces are the per-shard shapes the sweep plans:
            # w_in at its segments' width, padded when packed
            assert res["pieces"] == res["shapes"], (res["pieces"],
                                                    res["shapes"])
            assert [cfg.d_model, di + 2 * gn + h // 2] in res["pieces"]
            assert "embed/head" in res["packed"]
            for b in BUCKETS:
                assert res["conv"][str(b)][-1] == di // 2 + 2 * gn
            for b, _, _ in GROUPS:
                np.testing.assert_array_equal(out[f"{arch}_tokens_{b}"],
                                              want[f"tokens_{b}"])
                _close(out[f"{arch}_logits_{b}"], want[f"logits_{b}"])
                bucket = res[f"buckets_{b}"][0]
                split_rows = dp > 1 and bucket % dp == 0
                rows = bucket // dp if split_rows else bucket
                contract = decode_contract(cfg, rows)
                if cfg.family == "hybrid" and dp > 1 and not split_rows:
                    assert "seq='data'" in res["layouts"][str(bucket)]
                    ag = contract["all-gather"]
                    s = seq_split_gathers(cfg, rows)
                    contract["all-gather"] = {
                        k: ag[k] + s[k] for k in ag}
                assert res[f"decode_{b}"] == contract, (arch, b)
            if world != 2:
                continue
            # the segmented cut: the rank's heads' columns of the
            # reference's leaves, and init_pieces cut alike
            assert res["init_pieces_equal"]
            p0 = want["p0"]
            for name in ("w_in", "conv_w", "conv_b"):
                cols = segments(cfg, rank, p0[name].shape[-1])
                np.testing.assert_array_equal(out[f"{arch}_{name}"],
                                              p0[name][..., cols])
            # the block on the rank's pieces against the whole block
            mod = want["mod"]
            heads = slice(rank * h // 2, (rank + 1) * h // 2)
            conv_cols = segments(cfg, rank, di + 2 * gn)
            _close(out[f"{arch}_mod_y"], mod["y"])
            _close(out[f"{arch}_mod_yd"], mod["yd"])
            _close(out[f"{arch}_mod_h"], mod["h"][:, heads])
            _close(out[f"{arch}_mod_ssm"], mod["ssm"][:, heads])
            _close(out[f"{arch}_mod_tail"], mod["tail"][..., conv_cols])
            _close(out[f"{arch}_mod_conv"], mod["conv"][..., conv_cols])
