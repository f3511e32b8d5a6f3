"""Sharded training on the port (gloo, CPU) against the reference's
single-device train step.

The reduced qwen1.5-4b widened as the tensor-parallel serving tests widen
it (d_model 512, d_ff 1024, 4 heads of 128), fp32, 2 layers, remat on.
The parent runs the reference's ``jax.jit(make_train_step(...))`` on its
params and the seeded synthetic batches (global batch 4 x 32 tokens) for
2 steps, with ``microbatch`` 1 and 2 and a ``bf16_ef`` case.  Ranks
spawned over a file store in ``tmp_path`` (2, then 4) each carry their
pieces of the same params (``params_from_numpy``'s sharded form) and
build their rows of the same batches, then train on each mesh of the
case list under ``sharding_ctx``: ``data=2`` (DP), ``model=2`` (TP),
``data=2`` with FSDP, and on 4 ranks ``data=2,model=2`` with FSDP; and
``data=2`` with the first labels of row 0 masked, so the ranks hold
different label counts (a mean of the ranks' losses would differ).

Checks, on every rank: the loss, ``grad_norm`` and ``lr`` within rtol
1e-5 of the reference's; every piece of the params and of both moments
(which carry the gradients) within ``atol * max|reference leaf| + rtol *
|reference|``, 1e-4 each (the one-rank parity tests' fp32 bound:
torch and XLA sum in different orders; here the data group's partial
gradients are summed too).  ``bf16_ef`` rounds the reduced gradient to
bf16, where a last-bit difference of the fp32 sums can move an element
by one bf16 ulp (2^-8 of it): there m and v are held within
``EF_ULPS`` = 2^-7 of their largest element, the params within the fp32
bound plus 2^-7 lr a step.  And each step's collectives equal to the
contract derived from the shapes (:func:`contract`).  Besides: the
autograd collectives' gradients against one-rank autograd (Megatron's
*f* and *g*, the logits gather, FSDP's gather), the SSM family refused
on a mesh, and the launcher under torchrun.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import ShapeSpec as RefShapeSpec
from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.data.pipeline import SyntheticData as RefData
from repro.models.registry import build_model as ref_build_model
from repro.optim.adamw import OptConfig as RefOptConfig
from repro.train import step as ref_step
from repro_torch.analysis.collectives import collective_bytes
from repro_torch.configs.base import get_reduced_config
from repro_torch.models.param import MetaGenerator
from repro_torch.models.registry import build_model
from repro_torch.sharding.rules import (Mesh, ShardingOptions, local_shape,
                                        local_shard, param_pspecs,
                                        spec_leaves)

REPO = Path(__file__).resolve().parents[1]
WIDE = dict(d_model=512, d_ff=1024, num_heads=4, num_kv_heads=4,
            head_dim=128, dtype="float32")
OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=10, eps=1e-3)
TOL = dict(atol=1e-4, rtol=1e-4, loss=1e-5)
EF_ULPS = 2.0 ** -7
BATCH, SEQ, STEPS = 4, 32, 2
TIMEOUT = 240

# name -> (data, model, fsdp, microbatch, compress, masked); the ranks of
# a world run its cases in order on one process group.  ``masked``: the
# first MASKED labels of global row 0 are -100, so the data ranks hold
# different label counts (the global loss is not the mean of the ranks')
CASES = {
    "dp": (2, 1, False, 1, None, False),
    "dp-mb2": (2, 1, False, 2, None, False),
    "dp-masked": (2, 1, False, 1, None, True),
    "tp": (1, 2, False, 1, None, False),
    "tp-mb2": (1, 2, False, 2, None, False),
    "fsdp": (2, 1, True, 1, None, False),
    "fsdp-mb2": (2, 1, True, 2, None, False),
    "fsdp-bf16_ef": (2, 1, True, 1, "bf16_ef", False),
    "dp_tp_fsdp": (2, 2, True, 1, None, False),
    "dp_tp_fsdp-mb2": (2, 2, True, 2, None, False),
}
MASKED = 24

WORKER = textwrap.dedent("""
    import json, os, sys, traceback
    import numpy as np
    import torch
    from repro_torch.analysis.collectives import collective_bytes
    from repro_torch.configs.base import ShapeSpec, get_reduced_config
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.param import (MetaGenerator, params_from_numpy,
                                          tree_leaves)
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.sharding import comm
    from repro_torch.sharding.context import sharding_ctx
    from repro_torch.sharding.rules import ShardingOptions
    from repro_torch.train import loop
    from repro_torch.train.step import init_train_state, make_train_step

    torch.set_num_threads(1)
    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    job = json.load(open(os.path.join(out, "job.json")))
    cfg = get_reduced_config("qwen1_5_4b").reduced(**job["wide"])
    model = build_model(cfg)
    axes = model.init(MetaGenerator())[1]
    flat = np.load(os.path.join(out, "params.npz"))
    tree = {}
    for key in flat.files:
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    shape = ShapeSpec("t", job["seq"], job["batch"], "train")
    store = os.path.join(out, "store")
    res, arrays = {}, {}
    for name, (d, m, fsdp, mb, compress, masked) in job["cases"].items():
        mesh = make_mesh((d, m), ("data", "model"), device="cpu", rank=rank,
                         world_size=world, init_file=store, verbose=False)
        opts = ShardingOptions(fsdp=fsdp)
        ocfg = OptConfig(**job["opt"], compress=compress)
        params = params_from_numpy(tree, "cpu", mesh=mesh, axes=axes,
                                   opts=opts)
        state = init_train_state(model, ocfg, params=params)
        step = make_train_step(model, ocfg, microbatch=mb)
        data = SyntheticData(cfg, shape, seed=7, device="cpu", mesh=mesh,
                             batch_spec=loop._batch_spec(mesh, opts))
        steps = []
        with sharding_ctx(mesh, opts):
            for i in range(job["steps"]):
                batch = data.batch(i)
                if masked and data.rows()[0] == 0:
                    batch["labels"][0, :job["masked"]] = -100
                with comm.recording() as rec:
                    state, met = step(state, batch)
                steps.append({"metrics": {k: float(v)
                                          for k, v in met.items()},
                              "rows": int(batch["tokens"].shape[0]),
                              "collectives": collective_bytes(rec)})
                for key, t in (("p", state["params"]),
                               ("m", state["opt"]["m"]),
                               ("v", state["opt"]["v"])):
                    for n, leaf in enumerate(tree_leaves(t)):
                        arrays[f"{name}/{i}/{key}/{n}"] = leaf.numpy().copy()
        res[name] = {"coords": mesh.coords, "backend": mesh.backend,
                     "steps": steps}

    # the autograd collectives against one-rank autograd on the same
    # numbers (every rank draws them all from one seed)
    mesh = make_mesh((1, world), ("data", "model"), device="cpu",
                     rank=rank, world_size=world, init_file=store,
                     verbose=False)
    g = mesh.group("model")
    me = mesh.coords["model"]
    gen = torch.Generator().manual_seed(3)
    x0 = torch.randn(3, 8, generator=gen, dtype=torch.float64)
    w1 = torch.randn(8, 4 * world, generator=gen, dtype=torch.float64)
    w2 = torch.randn(4 * world, 8, generator=gen, dtype=torch.float64)
    c = torch.randn(3, 8, generator=gen, dtype=torch.float64)
    xs = torch.randn(world, 3, 8, generator=gen, dtype=torch.float64)

    def leaves(*ts):
        return [t.clone().requires_grad_() for t in ts]

    # Megatron's MLP: f, a column-parallel and a row-parallel product, g
    x, a, b = leaves(x0, w1[:, 4 * me:4 * me + 4], w2[4 * me:4 * me + 4])
    y = comm.tp_sum(torch.relu(comm.tp_copy(x, g) @ a) @ b, g)
    (y * c).sum().backward()
    x1, a1, b1 = leaves(x0, w1, w2)
    y1 = torch.relu(x1 @ a1) @ b1
    (y1 * c).sum().backward()
    ag = {"y": float((y - y1).abs().max()),
          "x": float((x.grad - x1.grad).abs().max()),
          "w1": float((a.grad - a1.grad[:, 4 * me:4 * me + 4]).abs().max()),
          "w2": float((b.grad - b1.grad[4 * me:4 * me + 4]).abs().max())}
    # the column-parallel output gathered, as the logits are
    x, a = leaves(x0, w1[:, 4 * me:4 * me + 4])
    z = comm.tp_gather(comm.tp_copy(x, g) @ a, g)
    (z * z).sum().backward()
    x1, a1 = leaves(x0, w1)
    z1 = x1 @ a1
    (z1 * z1).sum().backward()
    ag["gather"] = float((z - z1).abs().max())
    ag["gather_x"] = float((x.grad - x1.grad).abs().max())
    ag["gather_w1"] = float((a.grad - a1.grad[:, 4 * me:4 * me + 4])
                            .abs().max())
    # FSDP: each rank's shard gathered, each rank's own data through it
    s, = leaves(w2[4 * me:4 * me + 4])
    (xs[me] @ comm.fsdp_gather(s, g, 0).T).square().sum().backward()
    s1, = leaves(w2)
    sum((xs[r] @ s1.T).square().sum() for r in range(world)).backward()
    ag["fsdp"] = float((s.grad - s1.grad[4 * me:4 * me + 4]).abs().max())
    res["autograd"] = ag
    # a backward on a thread of its own (autograd runs a CUDA tensor's on
    # a device thread): its collectives land in the forward's recorder
    import threading
    x, s = leaves(x0, w2[4 * me:4 * me + 4])
    with comm.recording() as rec:
        loss = (comm.tp_copy(x, g) @ comm.fsdp_gather(s, g, 0).T).sum()
    th = threading.Thread(target=loss.backward)
    th.start()
    th.join(timeout=60)
    res["thread_ops"] = [r["op"] for r in rec]

    # an SSM model on a mesh is refused (the MoE family trains there:
    # tests/test_torch_dist_train_moe.py)
    ssm = build_model(get_reduced_config("mamba2_780m"))
    try:
        loop.run(ssm, shape, loop.LoopConfig(
            total_steps=1, ckpt_dir=os.path.join(out, f"ssm{rank}")),
            OptConfig(), device="cpu", mesh=mesh)
        res["ssm"] = "ran"
    except NotImplementedError as e:
        res["ssm"] = str(e)
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


@pytest.fixture(scope="module")
def reference():
    """The reference's params and, per (microbatch, compress, masked), each
    step's metrics and every leaf of params, m and v."""
    cfg = ref_reduced_config("qwen1_5_4b").reduced(**WIDE)
    model = ref_build_model(cfg)
    data = RefData(cfg, RefShapeSpec("t", SEQ, BATCH, "train"), seed=7)
    want, params = {}, None
    for mb, compress, masked in {c[3:] for c in CASES.values()}:
        ocfg = RefOptConfig(**OPT, compress=compress)
        state, _ = ref_step.init_train_state(model, ocfg,
                                             jax.random.PRNGKey(0))
        if params is None:
            params = flat_params(jax.tree.map(np.asarray, state["params"]))
        fn = jax.jit(ref_step.make_train_step(model, ocfg, microbatch=mb))
        steps = []
        for i in range(STEPS):
            batch = data.batch(i)
            if masked:
                batch["labels"] = batch["labels"].at[0, :MASKED].set(-100)
            state, met = fn(state, batch)
            steps.append({
                "metrics": {k: float(v) for k, v in met.items()},
                **{key: [np.asarray(x, np.float32)
                         for x in jax.tree.leaves(tree)]
                   for key, tree in (("p", state["params"]),
                                     ("m", state["opt"]["m"]),
                                     ("v", state["opt"]["v"]))}})
        want[(mb, compress, masked)] = steps
    return params, want


def spawn(tmp_path: Path, world: int, cases: dict, params: dict) -> list:
    np.savez(tmp_path / "params.npz", **params)
    (tmp_path / "job.json").write_text(json.dumps(
        {"wide": WIDE, "opt": OPT, "batch": BATCH, "seq": SEQ,
         "steps": STEPS, "cases": cases, "masked": MASKED}))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
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


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    """Each world's ranks, spawned once: 2 ranks for the one-axis meshes,
    4 for data=2,model=2."""
    params, _ = reference
    out = {}
    for world in (2, 4):
        cases = {n: c for n, c in CASES.items() if c[0] * c[1] == world}
        out[world] = spawn(tmp_path_factory.mktemp(f"world{world}"), world,
                           cases, params)
    return out


def full_shapes_and_specs(cfg, mesh, opts):
    model = build_model(cfg)
    params, axes = model.init(MetaGenerator())
    specs = param_pspecs(axes, params, mesh, opts)
    from repro_torch.models.param import tree_leaves
    return [tuple(t.shape) for t in tree_leaves(params)], spec_leaves(specs)


def contract(cfg, data: int, model: int, fsdp: bool, microbatch: int,
             rows: int, itemsize: int = 4) -> dict:
    """One step's collectives on a rank, from the shapes (``rows``: the
    rank's batch rows; fp32 compute).  Per micro-slice (``kk`` of the
    global batch, each rank's rows cut in order):

    * tensor parallelism, over ``model`` (a group of one rank included,
      as the serving sites): all-reduces of the (rows, seq, d_model)
      activations: the vocab-sharded lookup (1), ``wo`` and ``w_down``
      forward (2 a layer), remat's recompute of ``wo``'s in the backward
      (1 a layer: torch's non-reentrant checkpoint stops recomputing at
      a layer's last saved tensor, ``w_down``'s input, before its
      all-reduce), and *f*'s backward at q/k/v and at w_gate/w_up (2 a
      layer) and at the head (1); one all-gather of the (rows, seq,
      vocab) logits;
    * data parallelism, where ``data`` > 1: an all-reduce of the loss's
      sum and label count (2 fp32 numbers); each FSDP leaf's gradient
      reduce-scattered (its output: the rank's shard), every other leaf's
      all-reduced (the rank's piece).

    Per step: each FSDP leaf's shard all-gathered (its output: the piece
    FSDP does not split), and one all-reduce of the global norm's 4
    bytes over the world."""
    mesh = Mesh.of((data, model), ("data", "model"))
    opts = ShardingOptions(fsdp=fsdp)
    shapes, specs = full_shapes_and_specs(cfg, mesh, opts)
    global_rows = rows * data
    kk = (microbatch if microbatch > 1 and global_rows % microbatch == 0
          else 1)
    r = rows // kk
    act = r * SEQ * cfg.d_model * itemsize
    L = cfg.num_layers
    rec = []
    fs = [("data" in sp) and fsdp and data > 1 for sp in specs]
    pieces = [int(np.prod(local_shape(s, sp, mesh))) * itemsize
              for s, sp in zip(shapes, specs)]
    for piece, f in zip(pieces, fs):
        if f:
            rec.append(("all-gather", piece * data, data))
    for _ in range(kk):
        rec += [("all-reduce", act, model)] * (1 + 2 * L)
        rec.append(("all-gather", r * SEQ * cfg.vocab_size * itemsize, model))
        if data > 1:
            rec.append(("all-reduce", 8, data))
        rec += [("all-reduce", act, model)] * (L + 2 * L + 1)
        if data > 1:
            rec += [("reduce-scatter" if f else "all-reduce", piece, data)
                    for piece, f in zip(pieces, fs)]
    rec.append(("all-reduce", 4, data * model))
    return collective_bytes([{"op": o, "bytes": b, "group_size": n}
                             for o, b, n in rec])


def _close(got, want, what, slack: float = 0.0):
    """|got - want| <= atol max|want| + rtol |want| + slack, elementwise."""
    err = np.abs(got - want)
    bound = (TOL["atol"] * float(np.abs(want).max())
             + TOL["rtol"] * np.abs(want) + slack)
    assert np.all(err <= bound), (what, float(err.max()),
                                  float(np.abs(want).max()))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_the_reference(reference, worlds, name):
    data, model, fsdp, mb, compress, masked = CASES[name]
    _, want = reference
    ref = want[(mb, compress, masked)]
    cfg = get_reduced_config("qwen1_5_4b").reduced(**WIDE)
    mesh = Mesh.of((data, model), ("data", "model"))
    shapes, specs = full_shapes_and_specs(cfg, mesh,
                                          ShardingOptions(fsdp=fsdp))
    for rank, (out, res) in enumerate(worlds[data * model]):
        got = res[name]
        assert got["backend"] == "gloo"
        for i, st in enumerate(got["steps"]):
            for k in ("loss", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(
                    st["metrics"][k], ref[i]["metrics"][k], rtol=TOL["loss"],
                    atol=1e-7, err_msg=f"{name} rank {rank} step {i} {k}")
            for key in ("p", "m", "v"):
                for n, (w, sp) in enumerate(zip(ref[i][key], specs)):
                    slack = 0.0
                    if compress:
                        slack = (EF_ULPS * OPT["lr"] * (i + 1) if key == "p"
                                 else EF_ULPS * float(np.abs(w).max()))
                    piece = local_shard(w, sp, mesh, got["coords"])
                    _close(out[f"{name}/{i}/{key}/{n}"], piece,
                           (name, rank, i, key, n), slack)
            assert st["collectives"] == contract(cfg, data, model, fsdp, mb,
                                                 st["rows"]), (name, rank, i)
        assert got["steps"][0]["rows"] == BATCH // data


def test_autograd_collectives_match_one_rank_autograd(worlds):
    """*f*, *g*, the gather and FSDP's gather give one-rank autograd's
    gradients on every rank (float64).  A *g* whose backward all-reduced
    (``torch.distributed.nn``'s) would double ``w1``'s and ``x``'s."""
    for out, res in worlds[2]:
        for k, err in res["autograd"].items():
            assert err < 1e-12, (k, err, res["autograd"])


def test_backward_on_another_thread_records_into_the_forward_recorder(
        worlds):
    """The backward of *f* and of FSDP's gather, run on a thread of its
    own, records its all-reduce and reduce-scatter where the forward's
    all-gather went."""
    for _, res in worlds[2]:
        assert res["thread_ops"] == ["all-gather", "all-reduce",
                                     "reduce-scatter"] or \
            res["thread_ops"] == ["all-gather", "reduce-scatter",
                                  "all-reduce"], res["thread_ops"]


def test_remat_recomputes_in_the_callers_context():
    """A layer's recompute sees the sharding context of the forward that
    recorded it, where autograd runs the backward on another thread (as
    it does a CUDA tensor's): without it a tensor-parallel layer would
    recompute without its collectives."""
    import threading
    import types

    import torch

    from repro_torch.models.layers import remat
    from repro_torch.sharding.context import get_ctx, sharding_ctx
    seen = []

    def body(x):
        seen.append(get_ctx())
        return torch.sin(x * 2)

    x = torch.randn(8, requires_grad=True)
    with sharding_ctx(Mesh.of((1, 2), ("data", "model"))):
        y = remat(types.SimpleNamespace(remat=True), body, x).sum()
    th = threading.Thread(target=y.backward)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive() and x.grad is not None
    assert len(seen) == 2 and seen[0] is not None and seen[1] is seen[0]
    torch.testing.assert_close(x.grad, 2 * torch.cos(2 * x.detach()))


def test_ssm_is_refused_on_a_mesh(worlds):
    """The SSM family stays refused in training on a mesh, by a message
    that names the families a mesh step trains."""
    for _, res in worlds[2]:
        assert "dense and MoE families only" in res["ssm"] \
            and "'ssm'" in res["ssm"], res["ssm"]


def test_launcher_trains_sharded_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--reduced", "--device", "cpu", "--mesh", "--tp", "2", "--steps",
         "2", "--batch", "4", "--seq", "32", "--ckpt-dir",
         str(tmp_path / "ck")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh {'data': 1, 'model': 2} backend=gloo fsdp=False" in out.stdout
    # rank 0 prints alone
    assert out.stdout.count("ran 2 steps; loss ") == 1
    assert (tmp_path / "ck" / "LATEST").read_text() == "step_000000000002"
