"""The MoE family under tensor parallelism (gloo, CPU) against the
reference's single-device Engine.

Reduced OLMoE-1B-7B (GQA) and DeepSeek-V2 (MLA, one shared expert, a
leading dense layer), widened so every attention projection, the dense
layer's MLP and the head pack, fp32, with drops (capacity factor 1.0: a
group whose prompt is one token repeated sends every token to the same
experts, so prefill drops entries).  The parent builds the reference's
params and serves them on the reference's ``Engine``; for each mesh one
spawn of ranks over a file store serves both archs on ``Engine(mesh=)``
from their pieces (``params_from_numpy``'s sharded form) after ``install
--mesh``:

* ``model=2`` with 16 routed experts: the rules split the experts (8 a
  rank) and the router (its columns all-gathered);
* ``model=2`` with 8: fewer than 8 a rank would remain, so every
  expert's columns split (``w_gate`` / ``w_up`` column-, ``w_down``
  row-parallel) and the router is whole;
* ``data=2,model=2`` over 4 ranks with 16: the reference dispatches per
  data shard (``_dp_groups``, patched here to the mesh's 2 groups since
  the reference engine runs off a mesh): bucket 2 splits its rows over
  ``data`` (a rank's row is one group), bucket 1 is computed whole on
  every rank, which dispatches both groups itself.

Checks: tokens equal and logits within ``F32_TOL`` (1e-4 + 1e-4 |ref|),
the drop mask of ``moe_apply`` on the rank's pieces equal to the
reference's rule at both capacities, 0 registry misses, only the rank's
pieces held, MLA's latent cache split along its sequence at buckets 1
and 2, one decode call's collectives equal to the contract from the
shapes, OLMoE's queue, and the refusals kept, each by its message.
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
import torch

from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.core import registry as ref_registry
from repro.models import moe as ref_moe
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import Engine as RefEngine
from repro.serve.scheduler import Request as RefRequest
from repro_torch.configs.base import get_reduced_config
from repro_torch.sharding.context import check_dense_mesh
from repro_torch.sharding.rules import ShardingOptions

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("olmoe_1b_7b", "deepseek_v2_236b")
WIDE = {
    "olmoe_1b_7b": dict(d_model=512, num_heads=4, num_kv_heads=4,
                        head_dim=128, d_ff=1024),
    "deepseek_v2_236b": dict(d_model=512, num_heads=4, num_kv_heads=4,
                             head_dim=128, v_head_dim=128, rope_head_dim=64,
                             q_lora_rank=512, kv_lora_rank=512, d_ff=1024),
}
CF = 1.0
F32_TOL = 1e-4
TIMEOUT = 300
GROUPS = ((1, 16, -1), (2, 16, 1))     # batch, prompt, seed (-1: one token)
STEPS = 3
QUEUE = ((5, 3), (12, 2), (9, 4))      # prompt, max_new_tokens
MAX_LEN = 64                           # even: the latent cache's slots split
BUCKETS = (1, 2)
# the module check: (rows, tokens) of x, its first 8 tokens of each row
# one vector (sent to the same experts), at both capacities
MOE_X = (2, 16)
MOE_CF = (1.0, 8.0)
# spec -> (world, routed experts, the reference's dispatch groups)
MESHES = {"model=2": (2, 16, 1), "model=2,ff": (2, 8, 1),
          "data=2,model=2": (4, 16, 2)}


def cfg_pair(arch: str, experts: int):
    over = dict(WIDE[arch], dtype="float32", num_experts=experts,
                capacity_factor=CF)
    return (ref_reduced_config(arch).reduced(**over),
            get_reduced_config(arch).reduced(**over))


def prompt(cfg, b: int, plen: int, seed: int) -> np.ndarray:
    if seed < 0:
        return np.full((b, plen), 7, np.int32)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, plen)).astype(np.int32)


def moe_x(d: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    x = rng.standard_normal((*MOE_X, d)).astype(np.float32)
    x[:, :8] = x[0, 0]
    return x


def queue_reqs(cfg, cls):
    rng = np.random.default_rng(7)
    return [cls(tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                max_new_tokens=m, rid=i) for i, (n, m) in enumerate(QUEUE)]


WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core import registry
    from repro_torch.core.install import install_arch, parse_mesh
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

    rank, world, out, spec = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    cfg_in = json.load(open(os.path.join(out, "cfg.json")))
    buckets = tuple(cfg_in["buckets"])
    desc = parse_mesh(spec)
    mesh = make_mesh(tuple(desc.shape.values()), desc.axis_names,
                     device="cpu", rank=rank, world_size=world,
                     init_file=os.path.join(out, "store"), verbose=False)
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
                     device="cpu")
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
        params = params_from_numpy(tree, "cpu", mesh=mesh, axes=axes)
        mlp = layer_params(params["layers"], 0)["mlp"]
        r = {"w_gate": list(mlp["w_gate"].shape),
             "router": list(mlp["router"].shape)}
        # moe_apply on the rank's pieces of the first MoE layer, on the
        # whole bucket (every rank dispatches the data axis's groups) and
        # on the rank's data line's rows (one group): moe_groups picks g
        # from the ambient layout
        x = torch.from_numpy(np.load(os.path.join(out, "moe_x.npy")))
        dp = desc.shape.get("data", 1)
        cases = [("whole", x, None, dp)]
        if dp > 1:
            i = mesh.coords["data"]
            cases.append(("rows", x[i:i + 1], CacheLayout(rows="data"), 1))
        for cf in cfg_in["moe_cf"]:
            for name, xin, layout, g in cases:
                drops.clear()
                with torch.inference_mode(), sharding_ctx(mesh,
                                                          layout=layout):
                    assert moe_groups(xin.shape[0] * xin.shape[1]) == g
                    y, aux = moe.moe_apply(mlp, cfg, xin, capacity_factor=cf)
                keep = drops[0]
                tag = f"{arch}_moe_{name}_{cf}"
                arrays[tag] = y.numpy()
                arrays[tag + "_aux"] = aux.numpy()
                arrays[tag + "_keep"] = keep.numpy()
        eng = Engine(model, params, axes, max_len=cfg_in["max_len"],
                     buckets=buckets, max_prompt=16, device="cpu", mesh=mesh)
        attn = eng.params["layers"]["attn"]
        first = "wq_b" if cfg.use_mla else "wq"
        r["attn_cols"] = attn[first].shape[-1]
        r["head_cols"] = eng.params["embed"]["head"].shape[-1]
        r["packed"] = sorted(eng.pack_report)
        r["layouts"] = {str(b): repr(eng.cache_layout(b)) for b in buckets}
        slab = "c" if cfg.use_mla else "k"
        r["slab"] = {str(b): list(eng.programs.static_cache(
            b, cfg_in["max_len"])[slab].shape) for b in buckets}
        drops.clear()
        for b, plen, seed in cfg_in["groups"]:
            toks = np.load(os.path.join(out, f"toks_{arch}_{b}.npy"))
            got = eng.generate({"tokens": torch.from_numpy(toks)},
                               cfg_in["steps"])
            arrays[f"{arch}_tokens_{b}"] = got.tokens.numpy()
            arrays[f"{arch}_logits_{b}"] = got.logits_last.numpy()
            r[f"buckets_{b}"] = list(got.buckets)
            r[f"decode_{b}"] = eng.collectives("decode", got.buckets[0])
        r["engine_drops"] = int(sum(int((~k).sum()) for k in drops))
        if not cfg.use_mla:
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


def flat_params(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_params(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def ref_keep(router, x, k: int, g: int, cap: int) -> np.ndarray:
    """The reference's drop rule (``models/moe.py::moe_apply``'s
    dispatch, per group): each flat (token, choice) entry's keep, in
    entry order."""
    t, d = x.shape[0] * x.shape[1], x.shape[-1]
    xg = jnp.asarray(x).reshape(g, t // g, d)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg, router), axis=-1)
    top_e = np.asarray(jax.lax.top_k(probs, k)[1])
    keep = []
    for gi in range(g):
        flat = top_e[gi].reshape(-1)
        order = np.argsort(flat, kind="stable")
        es = flat[order]
        rank = np.arange(flat.size) - np.searchsorted(es, es, side="left")
        kk = np.empty(flat.size, bool)
        kk[order] = rank < cap
        keep.append(kk)
    return np.concatenate(keep)


def port_keep(keep_sorted, router, x, k: int, g: int) -> np.ndarray:
    """A port rank's keep (in its sort's order) back in entry order."""
    t, d = x.shape[0] * x.shape[1], x.shape[-1]
    probs = jax.nn.softmax(jnp.asarray(x).reshape(t, d) @ router, axis=-1)
    top_e = np.asarray(jax.lax.top_k(probs, k)[1]).reshape(-1)
    ar = np.arange(t * k)
    key = top_e + (ar // (t // g * k)) * router.shape[-1]
    order = np.argsort(key, kind="stable")
    out = np.empty(t * k, bool)
    out[order] = keep_sorted
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


def reference(arch: str, experts: int, groups: int) -> dict:
    """The reference's params, its single-device Engine's groups (and
    OLMoE's queue), its ``moe_apply`` on ``moe_x`` at each capacity, with
    ``_dp_groups`` giving ``groups`` where they divide the tokens."""
    key = (arch, experts, groups)
    if key in _REFS:
        return _REFS[key]
    ref_cfg, cfg = cfg_pair(arch, experts)

    def dp_groups(t):
        return groups if groups > 1 and t % groups == 0 and t >= groups \
            else 1

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
            cap = ref_moe._capacity(x.shape[0] * x.shape[1] // groups,
                                    cfg.num_experts, cfg.experts_per_token,
                                    cf)
            want[f"keep_whole_{cf}"] = ref_keep(
                np.asarray(mlp["router"]), x, cfg.experts_per_token, groups,
                cap)
        want["router"] = np.asarray(mlp["router"])
        want["flat"] = flat_params(jax.tree.map(np.asarray, params))
    _REFS[key] = (cfg, want)
    return _REFS[key]


def spawn(tmp_path: Path, spec: str, world: int, experts: int,
          groups: int) -> list:
    over = {}
    for arch in ARCHS:
        cfg, want = reference(arch, experts, groups)
        np.savez(tmp_path / f"params_{arch}.npz", **want["flat"])
        for b, _, _ in GROUPS:
            np.save(tmp_path / f"toks_{arch}_{b}.npy", want[f"toks_{b}"])
        over[arch] = dict(WIDE[arch], dtype="float32", num_experts=experts,
                          capacity_factor=CF)
    np.save(tmp_path / "moe_x.npy", moe_x(512))
    queue = [[q.tokens.tolist(), q.max_new_tokens]
             for q in queue_reqs(cfg, RefRequest)]
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"archs": ARCHS, "over": over, "buckets": BUCKETS, "groups": GROUPS,
         "steps": STEPS, "queue": queue, "max_len": MAX_LEN,
         "moe_cf": MOE_CF}))
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
             spec.split(",ff")[0]], env=env, stdout=subprocess.PIPE,
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
            for r in range(world)]


def decode_contract(cfg, rows: int, *, router_split: bool,
                    kv_seq_split: bool) -> dict:
    """One decode call's collectives on a rank computing ``rows`` rows,
    fp32, every group of 2 ranks: per layer ``wo``'s all-reduce; GQA
    over a cache split along its sequence, the partials' all-gather
    (every local head's (m, l, acc)); MLA (its latent cache always split
    along its sequence over ``model``), the all-gather of every head's
    c-space and rope query and of every head's partials; the dense
    layer's ``w_down`` all-reduce; the MoE layer's router all-gather
    where its columns split and its one fp32 all-reduce; per call the
    lookup's all-reduce and the logits' all-gather."""
    d, f = cfg.d_model, 4
    ar, ag = [rows * d * f], [rows * cfg.vocab_size * f]
    for i in range(cfg.num_layers):
        ar.append(rows * d * f)                                  # wo
        if cfg.use_mla:
            h, kvr = cfg.num_heads, cfg.kv_lora_rank
            ag.append(rows * h * (kvr + cfg.rope_head_dim) * f)  # q
            ag.append(2 * rows * h * (2 + kvr) * f)              # partials
        elif kv_seq_split:
            ag.append(2 * rows * (cfg.num_kv_heads // 2)
                      * (cfg.num_heads // cfg.num_kv_heads)
                      * (2 + cfg.head_dim) * f)
        ar.append(rows * d * f)                       # w_down / the MoE sum
        if i >= cfg.first_k_dense and router_split:
            ag.append(rows * cfg.num_experts * f)
    return {"all-reduce": {"count": len(ar), "bytes_moved": float(sum(ar)),
                           "tensor_bytes": float(sum(ar))},
            "all-gather": {"count": len(ag),
                           "bytes_moved": float(sum(ag)) / 2,
                           "tensor_bytes": float(sum(ag))}}


def _close(got, want):
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= F32_TOL + F32_TOL * np.abs(want)), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("spec", list(MESHES))
def test_moe_tp_engine_matches_the_reference(ref_env, tmp_path, spec):
    world, experts, groups = MESHES[spec]
    ranks = spawn(tmp_path, spec, world, experts, groups)
    dp = world // 2
    for arch in ARCHS:
        cfg, want = reference(arch, experts, groups)
        e, ff = cfg.num_experts, cfg.d_ff_expert
        for rank, (out, allres) in enumerate(ranks):
            res = allres[arch]
            assert res["misses"] == 0 and res["healthy"], res
            # only the rank's pieces: the experts or their columns, the
            # router's columns where the experts split, half the heads
            # and half the vocabulary
            if e // 2 >= 8:
                assert res["w_gate"] == [e // 2, cfg.d_model, ff]
                assert res["router"] == [cfg.d_model, e // 2]
            else:
                assert res["w_gate"] == [e, cfg.d_model, ff // 2]
                assert res["router"] == [cfg.d_model, e]
            width = (cfg.head_dim + cfg.rope_head_dim if cfg.use_mla
                     else cfg.head_dim)
            assert res["attn_cols"] == cfg.num_heads * width // 2
            assert res["head_cols"] == cfg.vocab_size // 2
            packed = set(res["packed"])
            assert "embed/head" in packed
            if cfg.use_mla:
                # the latent cache split along its sequence at every bucket
                for b in BUCKETS:
                    assert "seq='model'" in res["layouts"][str(b)]
                    assert res["slab"][str(b)][2] == MAX_LEN // 2
                assert {"layers/attn/wq_b", "layers/attn/wkv_b",
                        "layers/attn/wo"} <= packed
            for b, _, _ in GROUPS:
                np.testing.assert_array_equal(out[f"{arch}_tokens_{b}"],
                                              want[f"tokens_{b}"])
                _close(out[f"{arch}_logits_{b}"], want[f"logits_{b}"])
                bucket = res[f"buckets_{b}"][0]
                split_rows = dp > 1 and bucket % dp == 0
                rows = bucket // dp if split_rows else bucket
                assert res[f"decode_{b}"] == decode_contract(
                    cfg, rows, router_split=e // 2 >= 8,
                    kv_seq_split=dp > 1 and not split_rows), (arch, b)
            if dp == 1:
                assert res["engine_drops"] > 0       # the one-token prompt
            if not cfg.use_mla:
                assert res["admitted"] == len(QUEUE)
                for i in range(len(QUEUE)):
                    np.testing.assert_array_equal(
                        out[f"{arch}_queue_{i}"], want[f"queue_{i}"])
            # moe_apply on the rank's pieces: the same entries dropped as
            # the reference's rule, the output within the bound
            i = rank // 2
            x = moe_x(cfg.d_model)
            for cf in MOE_CF:
                cases = [("whole", x, groups, want[f"moe_{cf}"])]
                if dp > 1:
                    cases.append(("rows", x[i:i + 1], 1, None))
                for name, xin, g, y in cases:
                    tag = f"{arch}_moe_{name}_{cf}"
                    got_keep = port_keep(out[tag + "_keep"], want["router"],
                                         xin, cfg.experts_per_token, g)
                    if name == "rows":
                        # a data rank's row is its group of the whole batch
                        whole = want[f"keep_whole_{cf}"]
                        n = got_keep.size
                        np.testing.assert_array_equal(
                            got_keep, whole[i * n:(i + 1) * n])
                        _close(out[tag], want[f"moe_{cf}"][i:i + 1])
                        continue
                    np.testing.assert_array_equal(
                        got_keep, want[f"keep_whole_{cf}"])
                    _close(out[tag], y)
                    assert abs(float(out[tag + "_aux"])
                               - want[f"moe_{cf}_aux"]) <= 1e-5
                    if cf == 1.0:
                        assert not got_keep.all()    # entries were dropped
                    else:
                        assert got_keep.all()


# the SSM family and the hybrid widened as tests/test_torch_tp_ssm.py
# widens them
SSM_WIDE = {"mamba2_780m": dict(d_model=512, num_heads=0, num_kv_heads=0,
                                d_ff=0),
            "zamba2_2_7b": dict(d_model=512, num_heads=4, num_kv_heads=4,
                                head_dim=128, d_ff=1024)}
# the VLM and encoder-decoder families widened as
# tests/test_torch_tp_vlm_encdec.py widens them
VLM_WIDE = {"llava_next_mistral_7b": dict(d_model=512, num_heads=4,
                                          num_kv_heads=2, head_dim=128,
                                          d_ff=1024),
            "whisper_base": dict(d_model=512, num_heads=4, num_kv_heads=4,
                                 head_dim=128, d_ff=1024, vocab_size=517)}


class _FakeMesh:
    """A process mesh's surface for ``check_dense_mesh``."""
    shape = {"data": 2, "model": 2}
    backend = "gloo"
    device = torch.device("cpu")

    def group(self, axis):
        return None


@pytest.mark.parametrize("arch,opts,serving,message", [
    # served since the SSM and hybrid families run under FSDP and 2D
    # tensor parallelism (tests/test_torch_tp2d_ssm.py): no message
    ("mamba2_780m", ShardingOptions(fsdp=True), True, None),
    ("zamba2_2_7b", ShardingOptions(fsdp=True, serve_2d_tp=True), True,
     None),
    # served since the VLM and encoder-decoder families run under FSDP
    # and 2D tensor parallelism (tests/test_torch_tp2d_vlm_encdec.py): no
    # message
    ("llava_next_mistral_7b", ShardingOptions(fsdp=True), True, None),
    ("whisper_base", ShardingOptions(fsdp=True, serve_2d_tp=True), True,
     None),
    # their training on a mesh and their sequence parallelism still refused
    ("llava_next_mistral_7b", ShardingOptions(fsdp=True), False,
     "dense and MoE families only"),
    ("whisper_base", ShardingOptions(fsdp=True, sequence_parallel="model"),
     True, "with sequence parallelism"),
    # served since the MoE family runs under FSDP and 2D tensor
    # parallelism (tests/test_torch_tp2d_moe.py): no message
    ("olmoe_1b_7b", ShardingOptions(fsdp=True), True, None),
    ("deepseek_v2_236b", ShardingOptions(fsdp=True, serve_2d_tp=True), True,
     None),
    ("olmoe_1b_7b", ShardingOptions(sequence_parallel="model"), True,
     "with sequence parallelism"),
    # trained on a mesh since the MoE family trains there
    # (tests/test_torch_dist_train_moe.py): no message
    ("olmoe_1b_7b", ShardingOptions(), False, None),
    ("deepseek_v2_236b", ShardingOptions(), False, None),
])
def test_the_refusals_kept(arch, opts, serving, message):
    """Each refusal by its message; a case with no message is served (or
    trained, where ``serving`` is False), and returns the head split
    (MLA's three head projections together; the Mamba2 heads where the
    model has them; the VLM's and the encoder-decoder's query and KV
    heads)."""
    cfg = get_reduced_config(arch)
    if message is None:
        split = check_dense_mesh(cfg.reduced(**{**SSM_WIDE, **VLM_WIDE,
                                                **WIDE}[arch]),
                                 _FakeMesh(), opts, "serving",
                                 serving=serving)
        assert split["qheads"] == bool(cfg.num_heads)
        assert ("kvheads" in split) != cfg.use_mla
        assert split.get("ssm_heads", False) == bool(cfg.ssm_state)
        return
    with pytest.raises(NotImplementedError, match=message):
        check_dense_mesh(cfg, _FakeMesh(), opts, "serving", serving=serving)


def test_the_moe_family_passes_the_serving_check():
    """Both MoE archs pass on a plain (data, model) mesh; MLA's three
    head projections split together."""
    for arch in ARCHS:
        cfg = get_reduced_config(arch).reduced(**WIDE[arch])
        split = check_dense_mesh(cfg, _FakeMesh(), ShardingOptions(),
                                 "serving", serving=True)
        assert split["qheads"]
