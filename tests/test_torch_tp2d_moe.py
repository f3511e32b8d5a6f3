"""The MoE family under 2D weight-stationary tensor parallelism and FSDP
serving (gloo, CPU) against the reference's single-device Engine.

Reduced OLMoE-1B-7B (GQA) and DeepSeek-V2 (MLA, one shared expert, a
leading dense layer), widened as in ``test_torch_tp_moe.py`` so every
attention projection, the dense layer's MLP and the head pack (but
DeepSeek's ``wkv_a``, whose 576 columns no block divides), fp32, 16
routed experts, capacity factor 1.0.  For each layout one spawn of four
ranks over a file store, ``data=2,model=2``, serves both archs on
``Engine(mesh=, opts=)`` from their pieces (``params_from_numpy``'s
sharded form) after ``install_arch(mesh=, opts=)``:

* ``ShardingOptions(fsdp=True, serve_2d_tp=True)`` (2D): every rank
  computes the whole bucket over pieces that never move: the router's
  fp32 partial logits and the experts' ``w_gate`` / ``w_up`` partials
  summed over ``data``, the output's columns gathered over it, MLA's
  unpacked ``wkv_a`` contracted where it lies, the latent cache's rows on
  ``data`` and its slots on ``model`` at bucket 2;
* ``ShardingOptions(fsdp=True)`` (FSDP): each piece gathered over
  ``data`` before use, each data line computing its rows.

The reference dispatches per data shard (``_dp_groups``, patched to the
mesh's 2 groups, as the reference's own 8-device tests do not run on
this JAX).  Checks: tokens equal and logits within ``F32_TOL`` (1e-4 +
1e-4 |ref|), 0 registry misses, only the rank's pieces held, one decode
call's collectives equal to the contract from the shapes, no weight
gathered in a 2D decode call and 2D moving fewer bytes than FSDP,
OLMoE's queue under 2D, and ``moe_apply`` on the rank's pieces under
both layouts against the reference's (the drop mask at both capacities).
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

from repro.core import registry as ref_registry
from repro.models import moe as ref_moe
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import Engine as RefEngine
from repro.serve.scheduler import Request as RefRequest
from repro_torch.analysis.collectives import bytes_moved
from test_torch_tp_moe import (ARCHS, CF, F32_TOL, QUEUE, WIDE, cfg_pair,
                               flat_params, moe_x, port_keep, prompt,
                               queue_reqs, ref_keep)

REPO = Path(__file__).resolve().parents[1]
EXPERTS, GROUPS_DP = 16, 2
GROUPS = ((1, 16, -1), (2, 16, 1))     # batch, prompt, seed (-1: one token)
STEPS = 3
MAX_LEN = 64                           # even: the latent cache's slots split
BUCKETS = (1, 2)
MOE_CF = (1.0, 8.0)
TIMEOUT = 300
LAYOUTS = {"2d": dict(fsdp=True, serve_2d_tp=True), "fsdp": dict(fsdp=True)}


WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core import registry
    from repro_torch.core.install import install_arch, parse_mesh
    from repro_torch.core.linear import serving_ctx
    from repro_torch.core.plan import length_buckets_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.lm import layer_params
    from repro_torch.models.param import MetaGenerator, params_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request
    from repro_torch.sharding.context import (CacheLayout, moe_groups,
                                              sharding_ctx)
    from repro_torch.sharding.rules import ShardingOptions

    rank, world, out, layout = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    cfg_in = json.load(open(os.path.join(out, "cfg.json")))
    opts = ShardingOptions(**cfg_in["layouts"][layout])
    buckets = tuple(cfg_in["buckets"])
    desc = parse_mesh("data=2,model=2")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu", rank=rank,
                     world_size=world, init_file=os.path.join(out, "store"),
                     verbose=False)
    drops = []
    sound_route = moe.route

    def counting_route(*a, **kw):
        got = sound_route(*a, **kw)
        drops.append(got[3])
        return got

    moe.route = counting_route
    res, arrays = {}, {}
    for arch in cfg_in["archs"]:
        cfg = get_reduced_config(arch).reduced(**cfg_in["over"][arch])
        install_arch(cfg, buckets, length_buckets_for(16), mesh=desc,
                     opts=opts, device="cpu")
        registry.flush()
        misses0 = registry.stats()["misses"]
        model = build_model(cfg)
        axes = model.init(MetaGenerator())[1]
        flat = np.load(os.path.join(out, f"params_{arch}.npz"))
        tree = {}
        for key in flat.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
        params = params_from_numpy(tree, "cpu", mesh=mesh, axes=axes,
                                   opts=opts)
        mlp = layer_params(params["layers"], 0)["mlp"]
        r = {"pieces": {k: list(v.shape) for k, v in mlp.items()}}
        # moe_apply on the rank's pieces of the first MoE layer: on the
        # whole bucket (every rank dispatches the data axis's groups) and,
        # under FSDP, on the data line's rows (one group)
        x = torch.from_numpy(np.load(os.path.join(out, "moe_x.npy")))
        cases = [("whole", x, None, 2)]
        if not opts.serve_2d_tp:
            i = mesh.coords["data"]
            cases.append(("rows", x[i:i + 1], CacheLayout(rows="data"), 1))
        for cf in cfg_in["moe_cf"]:
            for name, xin, lay, g in cases:
                drops.clear()
                with torch.inference_mode(), serving_ctx(), \\
                        sharding_ctx(mesh, opts, layout=lay):
                    assert moe_groups(xin.shape[0] * xin.shape[1]) == g
                    y, aux = moe.moe_apply(mlp, cfg, xin, capacity_factor=cf)
                tag = f"{arch}_moe_{name}_{cf}"
                arrays[tag] = y.numpy()
                arrays[tag + "_aux"] = aux.numpy()
                arrays[tag + "_keep"] = drops[0].numpy()
        eng = Engine(model, params, axes, max_len=cfg_in["max_len"],
                     buckets=buckets, max_prompt=16, device="cpu", mesh=mesh,
                     opts=opts)
        attn = eng.params["layers"]["attn"]
        r["attn"] = {k: list(v.shape) for k, v in attn.items()
                     if k in ("wkv_a", "wq", "wq_a")}
        r["packed"] = {k: list(v) for k, v in eng.pack_report.items()}
        r["layouts"] = {str(b): repr(eng.cache_layout(b)) for b in buckets}
        # 2 x the bytes a layer of every weight piece of two dims or more
        # (packed blocks or unpacked), the size of its gather over data
        pieces = set()

        def walk(t, lead):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, lead or k == "layers")
                return
            t = getattr(t, "blocks", t)
            if t.ndim - lead >= 2:
                n = t.numel() // (t.shape[0] if lead else 1)
                pieces.add(2 * n * t.element_size())

        walk(eng.params, False)
        drops.clear()
        for b, plen, seed in cfg_in["groups"]:
            toks = np.load(os.path.join(out, f"toks_{arch}_{b}.npy"))
            got = eng.generate({"tokens": torch.from_numpy(toks)},
                               cfg_in["steps"])
            arrays[f"{arch}_tokens_{b}"] = got.tokens.numpy()
            arrays[f"{arch}_logits_{b}"] = got.logits_last.numpy()
            r[f"buckets_{b}"] = list(got.buckets)
            r[f"decode_{b}"] = eng.collectives("decode", got.buckets[0])
            # the all-gathers of one decode call whose tensor is a weight
            # piece of the rank gathered over data (2 x its bytes a layer)
            prog = next(p for p in eng.programs.programs()
                        if p.kind == "decode" and p.bucket == got.buckets[0])
            r[f"weight_gathers_{b}"] = sum(
                x["op"] == "all-gather" and x["bytes"] in pieces
                for x in prog.comm)
        if not cfg.use_mla and opts.serve_2d_tp:
            reqs = [Request(tokens=np.asarray(t, np.int32),
                            max_new_tokens=m, rid=i)
                    for i, (t, m) in enumerate(cfg_in["queue"])]
            results, stats = eng.serve_queue(reqs)
            for q in results:
                arrays[f"{arch}_queue_{q.rid}"] = np.asarray(q.tokens)
            r["admitted"] = stats.admitted
        r["misses"] = registry.stats()["misses"] - misses0
        r["healthy"] = eng.health_report()["healthy"]
        res[arch] = r
        del eng, params
    np.savez(os.path.join(out, f"out_{rank}.npz"), **arrays)
    json.dump(res, open(os.path.join(out, f"res_{rank}.json"), "w"))
    mesh.close()
""")

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
    """The reference's params, its single-device Engine's groups and
    OLMoE's queue, its ``moe_apply`` on ``moe_x`` at each capacity, with
    ``_dp_groups`` giving the mesh's 2 groups where they divide the
    tokens."""
    if arch in _REFS:
        return _REFS[arch]
    ref_cfg, cfg = cfg_pair(arch, EXPERTS)

    def dp_groups(t):
        return GROUPS_DP if t % GROUPS_DP == 0 and t >= GROUPS_DP else 1

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_moe, "_dp_groups", dp_groups)
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
        if not cfg.use_mla:
            results, _ = eng.serve_queue(queue_reqs(cfg, RefRequest))
            for q in results:
                want[f"queue_{q.rid}"] = np.asarray(q.tokens)
        mlp = jax.tree.map(lambda a: a[0], params["layers"]["mlp"])
        x = moe_x(cfg.d_model)
        for cf in MOE_CF:
            y, aux = ref_moe.moe_apply(mlp, ref_cfg, jnp.asarray(x),
                                       capacity_factor=cf)
            want[f"moe_{cf}"] = np.asarray(y)
            want[f"moe_{cf}_aux"] = float(aux)
            cap = ref_moe._capacity(x.shape[0] * x.shape[1] // GROUPS_DP,
                                    cfg.num_experts, cfg.experts_per_token,
                                    cf)
            want[f"keep_{cf}"] = ref_keep(np.asarray(mlp["router"]), x,
                                          cfg.experts_per_token, GROUPS_DP,
                                          cap)
        want["router"] = np.asarray(mlp["router"])
        want["flat"] = flat_params(jax.tree.map(np.asarray, params))
    _REFS[arch] = (cfg, want)
    return _REFS[arch]


def spawn(tmp_path: Path, layout: str) -> list:
    over = {}
    for arch in ARCHS:
        cfg, want = reference(arch)
        np.savez(tmp_path / f"params_{arch}.npz", **want["flat"])
        for b, _, _ in GROUPS:
            np.save(tmp_path / f"toks_{arch}_{b}.npy", want[f"toks_{b}"])
        over[arch] = dict(WIDE[arch], dtype="float32", num_experts=EXPERTS,
                          capacity_factor=CF)
    np.save(tmp_path / "moe_x.npy", moe_x(512))
    queue = [[q.tokens.tolist(), q.max_new_tokens]
             for q in queue_reqs(cfg, RefRequest)]
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"archs": ARCHS, "over": over, "buckets": BUCKETS, "groups": GROUPS,
         "steps": STEPS, "queue": queue, "max_len": MAX_LEN,
         "moe_cf": MOE_CF, "layouts": LAYOUTS}))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = []
    for r in range(4):
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   REPRO_TORCH_PLAN_CACHE=str(tmp_path / f"plans{r}.json"),
                   REPRO_TORCH_MEASURE_CACHE=str(tmp_path / f"meas{r}.json"),
                   REPRO_TORCH_MISS_LOG=str(tmp_path / f"miss{r}.json"),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(r), "4", str(tmp_path),
             layout], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
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
            for r in range(4)]


def decode_contract(cfg, layout: str, bucket: int, packed: dict,
                    e: int = 4) -> dict:
    """One decode call's collectives on a rank of ``data=2,model=2`` (every
    group of 2), from the shapes and the rank's packed block shapes
    (``packed``: the engine's pack report), activations of ``e`` bytes,
    the router's logits and the MoE partials in fp32.

    Both layouts: each norm's ``embed`` scale gathered over ``data``; the
    lookup summed over ``model`` and its columns gathered over ``data``;
    ``wo`` summed over ``model``; GQA over a cache whose slots lie on
    ``data`` (bucket 1) gathers its partials over it, MLA (slots on
    ``model``) every head's query and the partials over ``model``; the
    MoE layer's router logits gathered over ``model`` and its partials
    summed over it once; the logits gathered over ``model``.

    2D: every rank computes the bucket; each k-split product (the packed
    pieces with rows on ``data``, MLA's unpacked ``wkv_a``, the router's
    fp32 logits, the routed and shared experts' ``w_gate`` / ``w_up`` in
    one sum) summed over ``data``; ``wo``'s, ``w_down``'s and the MoE
    layer's columns gathered over ``data``; with the cache's rows on
    ``data`` (bucket 2) the attention output gathered over it.

    FSDP: a data line computes its rows of a bucket it splits (all of
    bucket 1); the ids gathered over ``data`` before the lookup; every
    packed piece, ``wkv_a``, the router and the expert stacks gathered
    over ``data`` before use."""
    d, v, H = cfg.d_model, cfg.vocab_size, cfg.num_heads
    two_d = layout == "2d"
    split = bucket % 2 == 0
    rows = bucket if two_d or not split else bucket // 2
    ops = []                                   # (op, tensor bytes)

    def ar(b):
        ops.append(("all-reduce", b))

    def ag(b):
        ops.append(("all-gather", b))

    def blocks(leaf):
        n = 1
        for s in packed[leaf][-4:]:
            n *= s
        return 2 * n * e

    def packed_product(leaf, n_out, cols_on_data=False):
        """A packed piece's product: 2D a k-split sum (rows on data) or
        the rank's columns; FSDP its gather."""
        if not two_d:
            ag(blocks(leaf))
        elif not cols_on_data:
            ar(rows * n_out // 2 * e)

    if two_d:
        ar(rows * d // 2 * e)
        ag(rows * d * e)
    else:
        ag(2 * rows * 4)
        ar(rows * d * e)
        ag(2 * rows * d * e)
    for i in range(cfg.num_layers):
        pre = f"dense{i}" if i < cfg.first_k_dense else "layers"
        ag(d * e)                                            # ln1
        if cfg.use_mla:
            kvr, dr = cfg.kv_lora_rank, cfg.rope_head_dim
            packed_product(f"{pre}/attn/wq_a", cfg.q_lora_rank * 2)
            if two_d:
                ar(rows * (kvr + dr) * e)                    # wkv_a summed
            else:
                ag(d * (kvr + dr) * e)                       # wkv_a gathered
            local = rows // 2 if two_d and split else rows
            ag(local * H * (kvr + dr) * 4)                   # every head's q
            ag(2 * local * H * (2 + kvr) * 4)                # the partials
            if two_d and split:
                ag(rows * H // 2 * cfg.v_head_dim * e)       # heads' output
        else:
            q = H * cfg.head_dim
            for w in ("wq", "wk", "wv"):
                packed_product(f"{pre}/attn/{w}", q)
            if bucket == 1:
                ag(2 * rows * H // 2 * (cfg.head_dim + 2) * 4)
            elif two_d:
                ag(rows * q // 2 * e)                        # attn output
        packed_product(f"{pre}/attn/wo", d, cols_on_data=True)
        ar(rows * d // (2 if two_d else 1) * e)              # wo's TP sum
        if two_d:
            ag(rows * d * e)
        ag(d * e)                                            # ln2
        if i < cfg.first_k_dense:
            for w in ("w_gate", "w_up"):
                packed_product(f"{pre}/mlp/{w}", cfg.d_ff)
            packed_product(f"{pre}/mlp/w_down", d, cols_on_data=True)
            ar(rows * d // (2 if two_d else 1) * e)
            if two_d:
                ag(rows * d * e)
            continue
        E, ff = cfg.num_experts, cfg.d_ff_expert
        sff = ff * cfg.num_shared_experts
        g = 2 if two_d and split or not two_d and not split and rows % 2 == 0 \
            else 1
        cap = max(8, -(-(int(rows // g * cfg.experts_per_token
                              * cfg.capacity_factor / E) + 1) // 8) * 8)
        if two_d:
            ar(rows * E // 2 * 4)                            # router
            ar((2 * E // 2 * g * cap * ff + 2 * rows * sff // 2) * e)
        else:
            ag(d * E // 2 * 4)                               # the router
            for w in ("w_gate", "w_up", "w_down"):
                ag(E // 2 * d * ff * e)                      # the stacks
                if sff:
                    ag(d * sff // 2 * e)                     # the shared
        ag(rows * E * 4)                                     # router cols
        ar(rows * d // (2 if two_d else 1) * 4)              # moe_sum
        if two_d:
            ag(rows * d * e)
    ag(d * e)                                                # final norm
    packed_product("embed/head", v)
    ag(rows * v * e)                                         # the logits
    out = {}
    for op, b in ops:
        acc = out.setdefault(op, {"count": 0, "bytes_moved": 0.0,
                                  "tensor_bytes": 0.0})
        acc["count"] += 1
        acc["bytes_moved"] += b * (1.0 if op == "all-reduce" else 0.5)
        acc["tensor_bytes"] += b
    return out


def _close(got, want):
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= F32_TOL + F32_TOL * np.abs(want)), \
        float(np.abs(got - want).max())


@pytest.fixture(scope="module")
def ranks(ref_env, tmp_path_factory):
    return {layout: spawn(tmp_path_factory.mktemp(f"tp2d_moe_{layout}"),
                          layout) for layout in LAYOUTS}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_moe_2d_and_fsdp_engine_matches_the_reference(ranks, layout):
    for arch in ARCHS:
        cfg, want = reference(arch)
        e, ff, d = cfg.num_experts, cfg.d_ff_expert, cfg.d_model
        for rank, (out, allres) in enumerate(ranks[layout]):
            res = allres[arch]
            assert res["misses"] == 0 and res["healthy"], res
            # only the rank's pieces: experts and their embed dim, the
            # router's rows and columns, the shared experts' both dims
            pieces = res["pieces"]
            n = cfg.num_layers - cfg.first_k_dense
            assert pieces["router"] == [d // 2, e // 2]
            assert pieces["w_gate"] == [e // 2, d // 2, ff]
            assert pieces["w_down"] == [e // 2, ff, d // 2]
            if cfg.num_shared_experts:
                sff = ff * cfg.num_shared_experts
                assert pieces["ws_gate"] == [d // 2, sff // 2]
                assert pieces["ws_down"] == [sff // 2, d // 2]
                # MLA's unpacked wkv_a: its rows on data, never packed
                assert res["attn"]["wkv_a"] == [
                    n, d // 2, cfg.kv_lora_rank + cfg.rope_head_dim]
                assert "layers/attn/wkv_a" not in res["packed"]
                for b in BUCKETS:
                    lay = res["layouts"][str(b)]
                    assert "seq='model'" in lay
                    assert ("rows='data'" in lay) == (b == 2)
            for b, _, _ in GROUPS:
                np.testing.assert_array_equal(out[f"{arch}_tokens_{b}"],
                                              want[f"tokens_{b}"])
                _close(out[f"{arch}_logits_{b}"], want[f"logits_{b}"])
                bucket = res[f"buckets_{b}"][0]
                assert res[f"decode_{b}"] == decode_contract(
                    cfg, layout, bucket, res["packed"]), (arch, b)
            if not cfg.use_mla and layout == "2d":
                assert res["admitted"] == len(QUEUE)
                for i in range(len(QUEUE)):
                    np.testing.assert_array_equal(
                        out[f"{arch}_queue_{i}"], want[f"queue_{i}"])
            # moe_apply on the rank's pieces: the reference's drops and
            # output (the whole batch); under FSDP a data line's row, its
            # group of the whole batch
            x = moe_x(d)
            i = rank // 2
            for cf in MOE_CF:
                tag = f"{arch}_moe_whole_{cf}"
                keep = port_keep(out[tag + "_keep"], want["router"], x,
                                 cfg.experts_per_token, GROUPS_DP)
                np.testing.assert_array_equal(keep, want[f"keep_{cf}"])
                assert keep.all() == (cf == 8.0)
                _close(out[tag], want[f"moe_{cf}"])
                assert abs(float(out[tag + "_aux"])
                           - want[f"moe_{cf}_aux"]) <= 1e-5
                if layout == "fsdp":
                    tag = f"{arch}_moe_rows_{cf}"
                    keep = port_keep(out[tag + "_keep"], want["router"],
                                     x[i:i + 1], cfg.experts_per_token, 1)
                    m = keep.size
                    np.testing.assert_array_equal(
                        keep, want[f"keep_{cf}"][i * m:(i + 1) * m])
                    _close(out[tag], want[f"moe_{cf}"][i:i + 1])


def test_moe_2d_decode_gathers_no_weight(ranks):
    """A 2D decode call gathers no weight piece (FSDP's gathers every
    packed piece, ``wkv_a``, the router and the expert stacks: the
    control of the count), and moves fewer bytes than FSDP's at every
    bucket."""
    for arch in ARCHS:
        for (_, two), (_, fsdp) in zip(ranks["2d"], ranks["fsdp"]):
            for b, _, _ in GROUPS:
                assert two[arch][f"weight_gathers_{b}"] == 0
                assert fsdp[arch][f"weight_gathers_{b}"] > 0
                assert 0 < bytes_moved(two[arch][f"decode_{b}"]) < \
                    bytes_moved(fsdp[arch][f"decode_{b}"])
