"""The MoE family trained on a process mesh (gloo, CPU) against the
reference's single-device train step.

Reduced OLMoE-1B-7B (GQA) and DeepSeek-V2 (MLA; its dense layer, then
one MoE layer with a shared expert), widened as the tensor-parallel
serving tests widen them (``tests/test_torch_tp_moe.py::WIDE``), fp32,
2 layers, remat on, capacity factor 1.0 with the first 16 tokens of every
row one token, so the dispatch drops entries.  The parent runs the
reference's ``jax.jit(make_train_step(...))`` on its params for 2 steps
of a global batch of 4 x 32 tokens, with ``_dp_groups`` patched to the
mesh's data size (the reference dispatches per data shard of the global
batch; off a mesh it would take one group).  Ranks spawned over a file
store (2, then 4) each carry their pieces of the same params
(``params_from_numpy``'s sharded form) and their rows of the same
batches, and train on each mesh of the case list under
``sharding_ctx``: ``data=2``, ``data=2`` with FSDP, ``model=2`` with 16
experts (the experts and the router split) and with 8 (every expert's
columns split, the router whole), and on 4 ranks ``data=2,model=2`` with
FSDP; DeepSeek-V2 also with ``microbatch`` 2 on ``data=2``, where the
reference is fed the global rows in the port's micro-slice order (slice
i holds each rank's rows i: rows [0, 2, 1, 3]).

Checks, on every rank: the loss, the aux loss (the global batch's) and
``grad_norm`` within rtol 1e-5 of the reference's; every piece of the
params and of both moments within ``1e-4 * max|reference leaf| + 1e-4 *
|reference|``; entries dropped; each step's collectives equal to the
contract derived from the shapes (:func:`contract`).  Besides, on
``model=2``: the MoE layer's and MLA's gradients (every leaf, and the
input) against one-rank autograd, for a split and a whole router and
split and whole shared experts; on ``data=2``: the ranks' aux shares
summing to the global batch's aux, their gradients its gradient; and
``moe_groups`` in training and serving.
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
from repro.models import moe as ref_moe
from repro.models.registry import build_model as ref_build_model
from repro.optim.adamw import OptConfig as RefOptConfig
from repro.train import step as ref_step
from repro_torch.analysis.collectives import collective_bytes
from repro_torch.configs.base import get_reduced_config
from repro_torch.models.param import MetaGenerator, tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.sharding.context import (CacheLayout, moe_groups,
                                          sharding_ctx, whole_rows)
from repro_torch.sharding.rules import (Mesh, ShardingOptions, local_shape,
                                        local_shard, param_pspecs,
                                        pspec_for, spec_leaves)

REPO = Path(__file__).resolve().parents[1]
WIDE = {
    "olmoe_1b_7b": dict(d_model=512, num_heads=4, num_kv_heads=4,
                        head_dim=128, d_ff=1024),
    "deepseek_v2_236b": dict(d_model=512, num_heads=4, num_kv_heads=4,
                             head_dim=128, v_head_dim=128, rope_head_dim=64,
                             q_lora_rank=512, kv_lora_rank=512, d_ff=1024),
}
CF = 1.0
OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=10, eps=1e-3)
TOL = dict(atol=1e-4, rtol=1e-4, loss=1e-5)
BATCH, SEQ, STEPS = 4, 32, 2
SKEW = 16                 # the first SKEW tokens of every row are one token
TIMEOUT = 240

# name -> (arch, routed experts, data, model, fsdp, microbatch); the ranks
# of a world run its cases in order
CASES = {
    "olmoe-dp": ("olmoe_1b_7b", 16, 2, 1, False, 1),
    "olmoe-fsdp": ("olmoe_1b_7b", 16, 2, 1, True, 1),
    "olmoe-tp": ("olmoe_1b_7b", 16, 1, 2, False, 1),
    "olmoe-tp-ff": ("olmoe_1b_7b", 8, 1, 2, False, 1),
    "olmoe-dp_tp_fsdp": ("olmoe_1b_7b", 16, 2, 2, True, 1),
    "deepseek-dp": ("deepseek_v2_236b", 16, 2, 1, False, 1),
    "deepseek-dp-mb2": ("deepseek_v2_236b", 16, 2, 1, False, 2),
    "deepseek-fsdp": ("deepseek_v2_236b", 16, 2, 1, True, 1),
    "deepseek-tp": ("deepseek_v2_236b", 16, 1, 2, False, 1),
    "deepseek-dp_tp_fsdp": ("deepseek_v2_236b", 16, 2, 2, True, 1),
}

# a case's last checkpoint restored on another mesh: name -> (data,
# model, fsdp); the experts split over model restored with embed on
# data, and the reverse
RESTORE = {"olmoe-tp": (2, 1, True), "olmoe-fsdp": (1, 2, False)}

# the layer-level gradient checks on model=2: name -> the MoE layer's
# (routed experts, expert d_ff), on the reduced DeepSeek-V2 at d 64 (one
# shared expert); 16 x 8: the router and the experts split, the shared
# expert (8 columns) whole; 8 x 64: the router whole, every expert's
# columns and the shared expert split
GRAD_CASES = {"moe-split_router-whole_shared": (16, 8),
              "moe-whole_router-split_shared": (8, 64)}
GRAD_D = 64
MLA_SMALL = dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                 v_head_dim=16, rope_head_dim=8, q_lora_rank=32,
                 kv_lora_rank=32, dtype="float32")

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    from repro_torch.analysis.collectives import collective_bytes
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import train_state_specs
    from repro_torch.models import attention, moe
    from repro_torch.models.param import (MetaGenerator, params_from_numpy,
                                          tree_leaves)
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.sharding import comm
    from repro_torch.sharding.context import sharding_ctx
    from repro_torch.sharding.rules import (ShardingOptions, local_params,
                                            param_pspecs)
    from repro_torch.train.step import init_train_state, make_train_step

    torch.set_num_threads(1)
    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    job = json.load(open(os.path.join(out, "job.json")))
    store = os.path.join(out, "store")
    drops = [0]
    sound_route = moe.route

    def counting_route(*a, **kw):
        got = sound_route(*a, **kw)
        drops[0] += int((~got[3]).sum())
        return got

    moe.route = counting_route

    def unflat(flat):
        tree = {}
        for key in flat.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
        return tree

    batches = np.load(os.path.join(out, "batches.npz"))
    res, arrays = {}, {}
    for name, (arch, experts, d, m, fsdp, mb) in job["cases"].items():
        cfg = get_reduced_config(arch).reduced(**job["over"][arch],
                                               num_experts=experts)
        model = build_model(cfg)
        axes = model.init(MetaGenerator())[1]
        mesh = make_mesh((d, m), ("data", "model"), device="cpu", rank=rank,
                         world_size=world, init_file=store, verbose=False)
        opts = ShardingOptions(fsdp=fsdp)
        ocfg = OptConfig(**job["opt"])
        params = params_from_numpy(unflat(np.load(os.path.join(
            out, f"params_{arch}_{experts}.npz"))), "cpu", mesh=mesh,
            axes=axes, opts=opts)
        state = init_train_state(model, ocfg, params=params)
        step = make_train_step(model, ocfg, microbatch=mb)
        n = job["batch"] // d
        lo = mesh.coords["data"] * n
        steps = []
        drops[0] = 0
        with sharding_ctx(mesh, opts):
            for i in range(job["steps"]):
                batch = {k: torch.from_numpy(batches[f"{k}_{i}"][lo:lo + n])
                         for k in ("tokens", "labels")}
                with comm.recording() as rec:
                    state, met = step(state, batch)
                steps.append({"metrics": {k: float(v)
                                          for k, v in met.items()},
                              "rows": n, "collectives": collective_bytes(rec)})
                for key, t in (("p", state["params"]),
                               ("m", state["opt"]["m"]),
                               ("v", state["opt"]["v"])):
                    for j, leaf in enumerate(tree_leaves(t)):
                        arrays[f"{name}/{i}/{key}/{j}"] = leaf.numpy().copy()
        res[name] = {"coords": mesh.coords, "backend": mesh.backend,
                     "steps": steps, "drops": drops[0]}
        if name in job["restore"]:
            # the checkpoint of the last step, restored on another mesh
            specs = train_state_specs(model, ocfg, mesh, opts)[1]
            mgr = CheckpointManager(os.path.join(out, f"ck_{name}"))
            mgr.save(job["steps"], state, block=True, specs=specs, mesh=mesh)
            torch.distributed.barrier()
            d2, m2, fsdp2 = job["restore"][name]
            mesh = make_mesh((d2, m2), ("data", "model"), device="cpu",
                             rank=rank, world_size=world, init_file=store,
                             verbose=False)
            full, specs, _ = train_state_specs(
                model, ocfg, mesh, ShardingOptions(fsdp=fsdp2))
            at, got = mgr.restore_latest(full, "cpu", specs, mesh)
            for key, t in (("p", got["params"]), ("m", got["opt"]["m"]),
                           ("v", got["opt"]["v"])):
                for j, leaf in enumerate(tree_leaves(t)):
                    arrays[f"{name}/restored/{key}/{j}"] = leaf.numpy()
            res[name]["restored"] = {"step": at, "coords": mesh.coords}

    if world == 2:
        # the layer-level gradients on model=2 against one-rank autograd
        # on the same numbers (every rank draws them all from one seed)
        mesh = make_mesh((1, 2), ("data", "model"), device="cpu", rank=rank,
                         world_size=world, init_file=store, verbose=False)
        opts = ShardingOptions()
        base = get_reduced_config("deepseek_v2_236b")

        def grads(fn, params, axes, x, c, on_mesh):
            specs = param_pspecs(axes, params, mesh, opts)
            p = local_params(params, specs, params, mesh) if on_mesh \\
                else params
            leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
            xx = x.clone().requires_grad_()
            with sharding_ctx(mesh if on_mesh else None, opts), \\
                    torch.enable_grad():
                y, aux = fn(leaves, xx)
                ((y * c).sum() + 10.0 * aux).backward()
            return ({k: v.grad for k, v in leaves.items()}, xx.grad, y,
                    specs)

        def compare(fn, params, axes, x, c):
            g1, gx1, y1, specs = grads(fn, params, axes, x, c, False)
            g2, gx2, y2, _ = grads(fn, params, axes, x, c, True)
            errs = {"y": float((y2 - y1).abs().max() / y1.abs().max()),
                    "x": float((gx2 - gx1).abs().max() / gx1.abs().max())}
            for k in g1:
                want = local_params({k: g1[k]}, {k: specs[k]},
                                    {k: g1[k]}, mesh)[k]
                errs[k] = float((g2[k] - want).abs().max()
                                / want.abs().max().clamp(min=1e-30))
            return errs

        ag = {}
        for gname, (e, ff) in job["grad_cases"].items():
            cfg = base.reduced(d_model=job["grad_d"], num_experts=e,
                               d_ff_expert=ff, experts_per_token=2,
                               capacity_factor=8.0, dtype="float32")
            params, axes = moe.init_moe(torch.Generator().manual_seed(5),
                                        cfg)
            gen = torch.Generator().manual_seed(6)
            x = torch.randn(2, 16, cfg.d_model, generator=gen)
            c = torch.randn(2, 16, cfg.d_model, generator=gen)
            ag[gname] = compare(
                lambda p, xx: moe.moe_apply(p, cfg, xx), params, axes, x, c)
        cfg = base.reduced(**job["mla"])
        params, axes = attention.init_mla(torch.Generator().manual_seed(7),
                                          cfg)
        gen = torch.Generator().manual_seed(8)
        x = torch.randn(2, 12, cfg.d_model, generator=gen)
        c = torch.randn(2, 12, cfg.d_model, generator=gen)
        ag["mla"] = compare(
            lambda p, xx: (attention.mla_forward(p, cfg, xx)[0],
                           torch.zeros(())), params, axes, x, c)
        res["layer_grads"] = ag

        # the aux shares on data=2: each rank's rows of one global batch
        # of router probabilities
        mesh = make_mesh((2, 1), ("data", "model"), device="cpu", rank=rank,
                         world_size=world, init_file=store, verbose=False)
        probs = torch.from_numpy(np.load(os.path.join(out, "probs.npy")))
        k = job["aux_k"]
        n = probs.shape[0] // 2
        mine = probs[rank * n:(rank + 1) * n].clone().requires_grad_()
        top = torch.topk(mine, k, dim=-1)[1].reshape(-1)
        with sharding_ctx(mesh, ShardingOptions()), comm.recording() as rec, \\
                torch.enable_grad():
            share = moe.load_balance_aux(mine, top, k, job["aux_coef"])
            share.backward()
        total = comm.all_reduce(share.detach().reshape(1).clone(),
                                mesh.group("data"))
        res["aux"] = {"share": float(share), "total": float(total[0]),
                      "collectives": collective_bytes(rec)}
        arrays["aux_grad"] = mine.grad.numpy()
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


def over(arch: str) -> dict:
    return dict(WIDE[arch], dtype="float32", capacity_factor=CF)


def batches(vocab: int) -> dict:
    """Each step's global batch: the first ``SKEW`` tokens of every row
    one token (routed alike, so the dispatch drops entries at capacity
    factor 1.0)."""
    rng = np.random.default_rng(3)
    out = {}
    for i in range(STEPS):
        toks = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
        toks[:, :SKEW] = 7
        out[f"tokens_{i}"] = toks[:, :-1]
        out[f"labels_{i}"] = toks[:, 1:]
    return out


def order_of(data: int, microbatch: int) -> list:
    """The global rows in the port's micro-slice order: slice i holds each
    data rank's rows i (of its ``BATCH / data`` rows cut into
    ``microbatch`` slices in order)."""
    n = BATCH // data
    kk = microbatch if microbatch > 1 and BATCH % microbatch == 0 else 1
    w = n // kk
    return [r * n + i * w + j for i in range(kk) for r in range(data)
            for j in range(w)]


def ref_params() -> dict:
    """Per (arch, experts): the reference's initial params, flat."""
    out = {}
    for arch, e, *_ in CASES.values():
        if (arch, e) not in out:
            cfg = ref_reduced_config(arch).reduced(**over(arch),
                                                   num_experts=e)
            params, _ = ref_build_model(cfg).init(jax.random.PRNGKey(0))
            out[arch, e] = flat_params(jax.tree.map(
                lambda x: np.asarray(x, np.float32), params))
    return out


def reference_steps() -> dict:
    """Per (arch, experts, data, microbatch): each step's metrics and
    every leaf of params, m and v."""
    want = {}
    for arch, e, d, _, _, mb in CASES.values():
        key = (arch, e, d, mb)
        if key in want:
            continue
        cfg = ref_reduced_config(arch).reduced(**over(arch), num_experts=e)
        model = ref_build_model(cfg)
        ocfg = RefOptConfig(**OPT)
        state, _ = ref_step.init_train_state(model, ocfg,
                                             jax.random.PRNGKey(0))

        def dp_groups(t, d=d):
            return d if d > 1 and t % d == 0 and t >= d else 1

        data = batches(cfg.vocab_size)
        rows = order_of(d, mb)
        steps = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_moe, "_dp_groups", dp_groups)
            fn = jax.jit(ref_step.make_train_step(model, ocfg, microbatch=mb))
            for i in range(STEPS):
                batch = {k: jnp.asarray(data[f"{k}_{i}"][rows])
                         for k in ("tokens", "labels")}
                state, met = fn(state, batch)
                steps.append({
                    "metrics": {k: float(v) for k, v in met.items()},
                    **{key: [np.asarray(x, np.float32)
                             for x in jax.tree.leaves(tree)]
                       for key, tree in (("p", state["params"]),
                                         ("m", state["opt"]["m"]),
                                         ("v", state["opt"]["v"]))}})
        want[key] = steps
    return want


AUX_PROBS = (16, 8)           # global tokens, experts
AUX_K, AUX_COEF = 2, 0.01


def aux_probs() -> np.ndarray:
    logits = np.random.default_rng(4).standard_normal(AUX_PROBS)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def start(tmp_path: Path, world: int, cases: dict, params: dict) -> list:
    """The ranks of one world, started (they run while the parent
    computes the reference's steps)."""
    for (arch, e), flat in params.items():
        np.savez(tmp_path / f"params_{arch}_{e}.npz", **flat)
    vocab = get_reduced_config("olmoe_1b_7b").vocab_size
    assert all(get_reduced_config(a).vocab_size == vocab for a in WIDE)
    np.savez(tmp_path / "batches.npz", **batches(vocab))
    np.save(tmp_path / "probs.npy", aux_probs())
    (tmp_path / "job.json").write_text(json.dumps(
        {"over": {a: over(a) for a in WIDE}, "opt": OPT, "batch": BATCH,
         "steps": STEPS, "cases": cases, "grad_cases": GRAD_CASES,
         "grad_d": GRAD_D, "mla": MLA_SMALL, "aux_k": AUX_K,
         "aux_coef": AUX_COEF,
         "restore": {n: r for n, r in RESTORE.items() if n in cases}}))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def finish(tmp_path: Path, procs: list) -> list:
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
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's steps, each world's ranks): 2 ranks for the
    one-axis meshes, 4 for data=2,model=2, running while the parent
    computes the reference."""
    params = ref_params()
    started = {}
    try:
        for world in (2, 4):
            cases = {n: c for n, c in CASES.items() if c[2] * c[3] == world}
            path = tmp_path_factory.mktemp(f"world{world}")
            started[world] = (path, start(path, world, cases, params))
        want = reference_steps()
    except BaseException:
        for _, procs in started.values():
            for p in procs:
                p.kill()
        raise
    return want, {w: finish(*started[w]) for w in started}


@pytest.fixture(scope="module")
def reference(runs):
    return runs[0]


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[1]


def port_cfg(arch: str, experts: int):
    return get_reduced_config(arch).reduced(**over(arch), num_experts=experts)


def full_shapes_and_specs(cfg, mesh, opts):
    params, axes = build_model(cfg).init(MetaGenerator())
    specs = param_pspecs(axes, params, mesh, opts)
    return [tuple(t.shape) for t in tree_leaves(params)], spec_leaves(specs)


def contract(cfg, data: int, model: int, fsdp: bool, microbatch: int,
             rows: int, seq: int = SEQ, itemsize: int = 4) -> dict:
    """One step's collectives on a rank, from the shapes (``rows``: the
    rank's batch rows; fp32 compute).  Per micro-slice (``kk`` of the
    global batch, each rank's rows cut in order), over ``model`` (a group
    of one included, as the serving sites) and, where ``data`` > 1, over
    ``data``:

    * the vocab-sharded lookup's all-reduce of the (rows, seq, d_model)
      activations, the (rows, seq, vocab) logits' all-gather and *f*'s
      backward at the head;
    * each layer's ``wo`` all-reduce, run again by remat's recompute (a
      layer after the leading dense ones: torch's non-reentrant
      checkpoint stops recomputing at a layer's last saved tensor, so a
      dense MLP's ``w_down`` all-reduce and the MoE layer's sum are not
      run again); *f*'s backward at the attention's input (GQA: once;
      MLA: at ``cq``, ``c_kv`` and ``k_rope``, the low-rank widths);
    * a dense layer's ``w_down`` all-reduce and *f* at w_gate / w_up;
    * an MoE layer's router all-gather of the (tokens, E) fp32 logits
      where the router splits, the data group's all-reduce of its E
      expert counts (both before the layer's last saved tensor: run
      again by the recompute), the one fp32 all-reduce of its partial
      output where the routed or the shared experts split, and *f*'s
      backward before each split consumer (the router, the routed
      experts, the shared experts) and, where the routed experts split,
      at the combine's (tokens, k) fp32 weights;
    * over ``data``: the loss's sum, label count and aux share (12 B),
      each FSDP leaf's gradient reduce-scattered, every other leaf's
      all-reduced.

    Per step: each FSDP leaf's shard all-gathered, and the global norm's
    4 bytes over the world."""
    mesh = Mesh.of((data, model), ("data", "model"))
    opts = ShardingOptions(fsdp=fsdp)
    shapes, specs = full_shapes_and_specs(cfg, mesh, opts)
    kk = (microbatch if microbatch > 1 and (rows * data) % microbatch == 0
          else 1)
    tok = rows // kk * seq
    d, e, f = cfg.d_model, cfg.num_experts, itemsize
    act = tok * d * f

    def split(axes, shape):
        return "model" in pspec_for(axes, shape, mesh, opts)

    router = split(("embed", "experts"), (d, e))
    routed = split(("experts", "embed", "mlp"), (e, d, cfg.d_ff_expert))
    shared = bool(cfg.num_shared_experts) and split(
        ("embed", "mlp"), (d, cfg.d_ff_expert * cfg.num_shared_experts))
    if cfg.use_mla:
        attn_f = [tok * w * f for w in (cfg.q_lora_rank, cfg.kv_lora_rank,
                                         cfg.rope_head_dim)]
    else:
        attn_f = [act]
    fs = [("data" in sp) and fsdp and data > 1 for sp in specs]
    pieces = [int(np.prod(local_shape(s, sp, mesh))) * f
              for s, sp in zip(shapes, specs)]
    rec = [("all-gather", p * data, data) for p, g in zip(pieces, fs) if g]
    for _ in range(kk):
        rec += [("all-reduce", act, model)] * 2           # lookup, head f
        rec.append(("all-gather", tok * cfg.vocab_size * f, model))
        for i in range(cfg.num_layers):
            runs = 1 if i < cfg.first_k_dense else 2       # remat
            rec += [("all-reduce", act, model)] * runs     # wo
            rec += [("all-reduce", b, model) for b in attn_f]
            if i < cfg.first_k_dense:
                rec += [("all-reduce", act, model)] * 2    # w_down, f
                continue
            if router:
                rec += [("all-gather", tok * e * 4, model)] * runs
            if data > 1:
                rec += [("all-reduce", e * 4, data)] * runs
            if routed or shared:
                rec.append(("all-reduce", tok * d * 4, model))
            rec += [("all-reduce", act, model)] * (router + routed + shared)
            if routed:                      # the combine's weights' f
                rec.append(("all-reduce", tok * cfg.experts_per_token * 4,
                            model))
        if data > 1:
            rec.append(("all-reduce", 12, data))
            rec += [("reduce-scatter" if g else "all-reduce", p, data)
                    for p, g in zip(pieces, fs)]
    rec.append(("all-reduce", 4, data * model))
    return collective_bytes([{"op": o, "bytes": b, "group_size": n}
                             for o, b, n in rec])


def _close(got, want, what):
    """|got - want| <= atol max|want| + rtol |want|, elementwise."""
    err = np.abs(got - want)
    bound = TOL["atol"] * float(np.abs(want).max()) + TOL["rtol"] * np.abs(
        want)
    assert np.all(err <= bound), (what, float(err.max()),
                                  float(np.abs(want).max()))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_moe_step_matches_the_reference(reference, worlds, name):
    arch, e, data, model, fsdp, mb = CASES[name]
    ref = reference[(arch, e, data, mb)]
    cfg = port_cfg(arch, e)
    mesh = Mesh.of((data, model), ("data", "model"))
    _, specs = full_shapes_and_specs(cfg, mesh, ShardingOptions(fsdp=fsdp))
    for rank, (out, res) in enumerate(worlds[data * model]):
        got = res[name]
        assert got["backend"] == "gloo"
        assert got["drops"] > 0, name          # the dispatch dropped entries
        for i, st in enumerate(got["steps"]):
            for k in ("loss", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(
                    st["metrics"][k], ref[i]["metrics"][k], rtol=TOL["loss"],
                    atol=1e-7, err_msg=f"{name} rank {rank} step {i} {k}")
            for key in ("p", "m", "v"):
                for n, (w, sp) in enumerate(zip(ref[i][key], specs)):
                    piece = local_shard(w, sp, mesh, got["coords"])
                    _close(out[f"{name}/{i}/{key}/{n}"], piece,
                           (name, rank, i, key, n))
            assert st["collectives"] == contract(cfg, data, model, fsdp, mb,
                                                 st["rows"]), (name, rank, i)
        assert got["steps"][0]["rows"] == BATCH // data


@pytest.mark.parametrize("case", [*GRAD_CASES, "mla"])
def test_tp_layer_gradients_match_one_rank_autograd(worlds, case):
    """On model=2, the MoE layer's output and its gradients (every leaf's
    piece, and the input's) from the rank's pieces equal one-rank
    autograd's (fp32; the loss weighs the aux loss in too): *f* before
    each split consumer only, *g* after the experts, the router's gather
    with gradients.  MLA: *f* on ``cq`` and ``ckv``, so ``wq_a``,
    ``wkv_a`` and both norms get their whole gradients on every rank."""
    if case in GRAD_CASES:            # the layouts the case is named after
        e, ff = GRAD_CASES[case]
        mesh, opts = Mesh.of((1, 2), ("data", "model")), ShardingOptions()
        split = ["model" in pspec_for(a, sh, mesh, opts) for a, sh in
                 ((("embed", "experts"), (GRAD_D, e)),
                  (("embed", "mlp"), (GRAD_D, ff)))]
        assert split == ["split_router" in case, "split_shared" in case]
    for _, res in worlds[2]:
        errs = res["layer_grads"][case]
        assert max(errs.values()) < 2e-5, errs


def test_aux_shares_sum_to_the_global_aux(worlds):
    """On data=2 each rank's share (its rows' mean probabilities over 2,
    times the data group's expert counts) sums to the reference's aux of
    the global batch (``models/moe.py``: ``E * coef * sum(me * ce)`` over
    every token), and each rank's gradient w.r.t. its rows' probabilities
    is the global aux's; one all-reduce of E fp32 counts."""
    probs = aux_probs()
    t, e = probs.shape

    def ref_aux(p):
        top = jax.lax.top_k(jax.lax.stop_gradient(p), AUX_K)[1].reshape(-1)
        me = p.mean(0)
        ce = jnp.zeros((e,), jnp.float32).at[top].add(1.0) / (t * AUX_K)
        return e * jnp.sum(me * ce) * AUX_COEF

    want = float(ref_aux(jnp.asarray(probs)))
    grad = np.asarray(jax.grad(ref_aux)(jnp.asarray(probs)))
    for rank, (out, res) in enumerate(worlds[2]):
        aux = res["aux"]
        np.testing.assert_allclose(aux["total"], want, rtol=1e-6)
        np.testing.assert_allclose(out["aux_grad"],
                                   grad[rank * t // 2:(rank + 1) * t // 2],
                                   rtol=1e-6, atol=1e-9)
        assert aux["collectives"] == {"all-reduce": {
            "count": 1, "bytes_moved": float(e * 4),
            "tensor_bytes": float(e * 4)}}


class _FakeMesh:
    """A process mesh's surface for ``moe_groups``."""
    shape = {"data": 2, "model": 2}

    def group(self, axis):
        return None


def test_moe_groups_in_training_and_serving():
    """A train step's rank holds its data line's rows: one group, where
    autograd records.  Serving keeps its rule: the data axis's groups
    where a rank computes the whole bucket (no layout, a gathered one,
    or a queue admission under ``whole_rows``), one on its data line's
    rows."""
    mesh = _FakeMesh()
    with sharding_ctx(mesh):
        with torch.enable_grad():
            assert moe_groups(64) == 1
        with torch.inference_mode():
            assert moe_groups(64) == 2
            assert moe_groups(3) == 1
    rows = CacheLayout(rows="data")
    with torch.inference_mode():
        with sharding_ctx(mesh, layout=rows):
            assert moe_groups(64) == 1
            with whole_rows():
                assert moe_groups(64) == 2
        with sharding_ctx(mesh, layout=CacheLayout(rows="data",
                                                   gathered=True)):
            assert moe_groups(64) == 2
    with torch.enable_grad():
        assert moe_groups(64) == 1                      # off a mesh


@pytest.mark.parametrize("name", list(RESTORE))
def test_moe_checkpoint_restores_on_another_mesh(reference, worlds, name):
    """A checkpoint written from a mesh (the expert stacks split over
    ``model``, or their ``embed`` dims over ``data`` under FSDP) restores
    each rank's pieces on the other layout: the full leaves gathered and
    cut again, against the reference's state after the last step."""
    arch, e, data, model, fsdp, mb = CASES[name]
    ref = reference[(arch, e, data, mb)][-1]
    d2, m2, fsdp2 = RESTORE[name]
    mesh = Mesh.of((d2, m2), ("data", "model"))
    _, specs = full_shapes_and_specs(port_cfg(arch, e), mesh,
                                     ShardingOptions(fsdp=fsdp2))
    assert any(("data" if fsdp2 else "model") in sp for sp in specs)
    for out, res in worlds[d2 * m2]:
        got = res[name]["restored"]
        assert got["step"] == STEPS
        for key in ("p", "m", "v"):
            for n, (w, sp) in enumerate(zip(ref[key], specs)):
                _close(out[f"{name}/restored/{key}/{n}"],
                       local_shard(w, sp, mesh, got["coords"]),
                       (name, key, n))


def test_launcher_trains_moe_on_a_mesh_and_resumes_on_one_rank(tmp_path):
    """``launch/train.py --mesh --tp 2 --arch olmoe_1b_7b`` under torchrun
    (every expert's columns split over ``model``), then the elastic
    restart on one rank: the loop resumes from the mesh's checkpoint."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import LoopConfig, run
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    ck = tmp_path / "ck"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "olmoe_1b_7b", "--reduced", "--device", "cpu", "--mesh",
         "--tp", "2", "--steps", "2", "--batch", "4", "--seq", "32",
         "--ckpt-dir", str(ck)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh {'data': 1, 'model': 2} backend=gloo fsdp=False" in out.stdout
    assert out.stdout.count("ran 2 steps; loss ") == 1
    rep = run(build_model(get_reduced_config("olmoe_1b_7b")),
              ShapeSpec("cli", 32, 4, "train"),
              LoopConfig(total_steps=3, ckpt_dir=str(ck)),
              OptConfig(lr=3e-4, warmup_steps=1, decay_steps=3),
              device="cpu")
    assert rep.resumed_from == 2 and rep.steps_run == 1
    assert np.isfinite(rep.losses).all()
