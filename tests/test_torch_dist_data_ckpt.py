"""Per-rank data, checkpoints across meshes and the elastic resume, on the
port (gloo, CPU).

* ``SyntheticData(mesh=, batch_spec=)``: each rank's batch bit-equal to
  its rows of the one-rank batch (tokens, labels, a VLM's embeds and
  -100 labels, an encoder-decoder's frames), at every position of a
  ``data=2,model=2`` mesh, and on the spawned ranks themselves.
* ``make_elastic_mesh``: the reference's 8 -> (4, 2) and 6 -> (3, 2).
* Checkpoints: a state saved on ``data=2`` with FSDP (rank 0 writes full
  leaves) restores bit-equal at ``model=2`` (each rank its pieces), on
  one rank, and in the reference's ``CheckpointManager``; a checkpoint
  the reference wrote restores onto a port mesh.
* The elastic resume: ``train.loop.run`` on 4 ranks (``data=2,model=2``,
  FSDP) fails after step 2 of 4; 2 ranks, the mesh ``make_elastic_mesh``
  gives 3 survivors with tp 2 (``data=1,model=2``), resume from the same
  checkpoint (the step read on rank 0 and broadcast), and their losses
  equal an uninterrupted one-rank run's within rtol 1e-5 (fp32).

The reduced qwen1.5-4b widened as in ``test_torch_dist_train.py``.
"""

import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as RefCheckpointManager
from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.models.registry import build_model as ref_build_model
from repro.optim.adamw import OptConfig as RefOptConfig
from repro.train import step as ref_step
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ShapeSpec, get_reduced_config
from repro_torch.data.pipeline import SyntheticData
from repro_torch.launch.specs import train_state_specs
from repro_torch.models.param import params_from_numpy, tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import OptConfig
from repro_torch.sharding.rules import (Mesh, P, ShardingOptions, local_shard,
                                        spec_leaves)
from repro_torch.train.loop import LoopConfig, make_elastic_mesh, run

REPO = Path(__file__).resolve().parents[1]
WIDE = dict(d_model=512, d_ff=1024, num_heads=4, num_kv_heads=4,
            head_dim=128, dtype="float32")
OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=10, eps=1e-3)
SHAPE = (32, 4)                  # tokens, global batch
RESUME = (4, 2)                  # total steps, fail_at
TIMEOUT = 240

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.base import ShapeSpec, get_reduced_config
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import train_state_specs
    from repro_torch.models.param import tree_leaves
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.sharding.context import sharding_ctx
    from repro_torch.sharding.rules import ShardingOptions, local_params
    from repro_torch.train import loop
    from repro_torch.train.step import init_train_state, make_train_step

    torch.set_num_threads(1)
    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    job = json.load(open(os.path.join(out, "job.json")))
    cfg = get_reduced_config("qwen1_5_4b").reduced(**job["wide"])
    model = build_model(cfg)
    ocfg = OptConfig(**job["opt"])
    flat = np.load(job["params"])
    params = {}
    for key in flat.files:
        node = params
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(flat[key])
    shape = ShapeSpec("t", *job["shape"], "train")
    store = os.path.join(out, "store")
    res, arrays = {"rank": rank}, {}

    def mesh_of(d, m):
        return make_mesh((d, m), ("data", "model"), device="cpu", rank=rank,
                         world_size=world, init_file=store, verbose=False)

    def dump(prefix, tree):
        for n, leaf in enumerate(tree_leaves(tree)):
            arrays[f"{prefix}/{n}"] = leaf.numpy().copy()

    total, fail_at = job["resume"]
    lcfg = loop.LoopConfig(total_steps=total, ckpt_every=fail_at,
                           ckpt_dir=job["resume_dir"])
    if world == 4:
        # the run that fails, on data=2,model=2 with FSDP; and each rank's
        # batch at step 0
        mesh = mesh_of(2, 2)
        opts = ShardingOptions(fsdp=True)
        data = SyntheticData(cfg, shape, seed=lcfg.seed, device="cpu",
                             mesh=mesh, batch_spec=loop._batch_spec(mesh, opts))
        for k, v in data.batch(0).items():
            arrays[f"batch/{k}"] = v.numpy()
        res["coords"] = mesh.coords
        try:
            loop.run(model, shape, lcfg, ocfg, device="cpu", params=params,
                     mesh=mesh, opts=opts, fail_at=fail_at)
            res["failed"] = None
        except loop.SimulatedFailure as e:
            res["failed"] = e.args[0]
    else:
        # the elastic resume: 3 survivors of 4, tp 2 -> data=1,model=2
        desc = loop.make_elastic_mesh(3, tp=2)
        mesh = mesh_of(*desc.shape.values())
        rep = loop.run(model, shape, lcfg, ocfg, device="cpu",
                       params=params, mesh=mesh)
        res["resume"] = {"resumed_from": rep.resumed_from,
                         "losses": rep.losses, "mesh": dict(mesh.shape)}
        # save on data=2 with FSDP after one step, restore at model=2
        fsdp = ShardingOptions(fsdp=True)
        mesh = mesh_of(2, 1)
        full, specs, _ = train_state_specs(model, ocfg, mesh, fsdp)
        state = init_train_state(model, ocfg, params=local_params(
            params, specs["params"], full["params"], mesh))
        data = SyntheticData(cfg, shape, seed=7, device="cpu", mesh=mesh,
                             batch_spec=loop._batch_spec(mesh, fsdp))
        with sharding_ctx(mesh, fsdp):
            state, _ = make_train_step(model, ocfg)(state, data.batch(0))
        mgr = CheckpointManager(job["save_dir"])
        mgr.save(1, state, specs=specs, mesh=mesh)
        dump("saved", state)
        res["saved_coords"] = mesh.coords
        tp = ShardingOptions()
        mesh = mesh_of(1, 2)
        full, specs, _ = train_state_specs(model, ocfg, mesh, tp)
        step, got = mgr.restore_latest(full, "cpu", specs, mesh)
        dump("restored", got)
        res["restored_step"] = step
        res["restored_coords"] = mesh.coords
        # the reference's checkpoint onto the same mesh
        step, got = CheckpointManager(job["ref_dir"]).restore_latest(
            full, "cpu", specs, mesh)
        dump("from_ref", got)
        res["from_ref_step"] = step
    np.savez(os.path.join(out, f"out_{rank}.npz"), **arrays)
    json.dump(res, open(os.path.join(out, f"res_{rank}.json"), "w"))
    mesh.close()
""")


def _cfg():
    return get_reduced_config("qwen1_5_4b").reduced(**WIDE)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("arch,keys", [
    ("qwen1_5_4b", ("tokens", "labels")),
    ("llava_next_mistral_7b", ("tokens", "labels", "embeds")),
    ("whisper_base", ("tokens", "labels", "enc_frames")),
])
@pytest.mark.parametrize("data,model", [(2, 2), (4, 1)])
def test_each_rank_builds_its_rows_bit_equal(arch, keys, data, model):
    cfg = get_reduced_config(arch)
    shape = ShapeSpec("t", 24, 4, "train")
    whole = SyntheticData(cfg, shape, seed=5, device="cpu").batch(3)
    desc = Mesh.of((data, model), ("data", "model"))
    rows = 4 // data
    for d in range(data):
        for m in range(model):
            mesh = types.SimpleNamespace(shape=desc.shape,
                                         coords={"data": d, "model": m})
            got = SyntheticData(cfg, shape, seed=5, device="cpu", mesh=mesh,
                                batch_spec=P("data")).batch(3)
            assert sorted(got) == sorted(keys)
            for k in keys:
                torch.testing.assert_close(
                    got[k], whole[k][d * rows:(d + 1) * rows], rtol=0, atol=0)


def test_a_batch_the_data_axis_does_not_divide_raises():
    mesh = types.SimpleNamespace(shape={"data": 3, "model": 1},
                                 coords={"data": 0, "model": 0})
    with pytest.raises(ValueError, match="does not split"):
        SyntheticData(_cfg(), ShapeSpec("t", 8, 4, "train"), device="cpu",
                      mesh=mesh, batch_spec=P("data")).batch(0)


@pytest.mark.parametrize("world,tp,shape", [(8, 2, (4, 2)), (6, 2, (3, 2)),
                                            (3, 2, (1, 2)), (4, 1, (4, 1))])
def test_elastic_mesh_fills_the_survivors(world, tp, shape):
    mesh = make_elastic_mesh(world, tp)
    assert tuple(mesh.shape.values()) == shape
    assert mesh.axis_names == ("data", "model")


def test_elastic_mesh_needs_a_model_line():
    with pytest.raises(ValueError):
        make_elastic_mesh(1, tp=2)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's params and a reference checkpoint (after one step);
    then 4 ranks (the failing run) and 2 (the elastic resume, the
    save / restore across meshes, the reference's checkpoint on a
    mesh)."""
    root = tmp_path_factory.mktemp("dist_ckpt")
    cfg = ref_reduced_config("qwen1_5_4b").reduced(**WIDE)
    model = ref_build_model(cfg)
    ocfg = RefOptConfig(**OPT)
    state, _ = ref_step.init_train_state(model, ocfg, jax.random.PRNGKey(0))
    params = _flat(jax.tree.map(np.asarray, state["params"]))
    np.savez(root / "params.npz", **params)
    from repro.configs import ShapeSpec as RefShapeSpec
    from repro.data.pipeline import SyntheticData as RefData
    batch = RefData(cfg, RefShapeSpec("t", *SHAPE, "train"), seed=7).batch(0)
    ref_state, _ = jax.jit(ref_step.make_train_step(model, ocfg))(state, batch)
    ref_mgr = RefCheckpointManager(root / "ref_ck")
    ref_mgr.save(1, ref_state, block=True)
    job = {"wide": WIDE, "opt": OPT, "shape": SHAPE, "resume": RESUME,
           "params": str(root / "params.npz"),
           "resume_dir": str(root / "resume_ck"),
           "save_dir": str(root / "save_ck"), "ref_dir": str(root / "ref_ck")}
    out = {}
    for world in (4, 2):
        d = root / f"world{world}"
        d.mkdir()
        (d / "job.json").write_text(json.dumps(job))
        (d / "worker.py").write_text(WORKER)
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, str(d / "worker.py"), str(r), str(world),
             str(d)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
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
        out[world] = [(np.load(d / f"out_{r}.npz"),
                       json.loads((d / f"res_{r}.json").read_text()))
                      for r in range(world)]
    return root, params, ref_state, out


def test_spawned_ranks_build_their_rows(spawned):
    _, _, _, out = spawned
    whole = SyntheticData(_cfg(), ShapeSpec("t", *SHAPE, "train"), seed=0,
                          device="cpu").batch(0)
    for arrays, res in out[4]:
        d = res["coords"]["data"]
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(arrays[f"batch/{k}"],
                                          whole[k][2 * d:2 * d + 2].numpy())


def _state_specs(mesh, fsdp):
    model = build_model(_cfg())
    full, specs, _ = train_state_specs(model, OptConfig(**OPT), mesh,
                                       ShardingOptions(fsdp=fsdp))
    return full, spec_leaves(specs)


def test_checkpoint_from_an_fsdp_mesh_restores_on_another(spawned):
    root, _, _, out = spawned
    full, _ = _state_specs(Mesh.of((1, 1), ("data", "model")), False)
    # on one rank, in the port and in the reference: the same full leaves
    one = tree_leaves(CheckpointManager(root / "save_ck").restore(
        1, full, "cpu"))
    ref_like = jax.tree.map(np.asarray, RefCheckpointManager(
        root / "save_ck").restore(1, _ref_like()))
    for a, b in zip(one, jax.tree.leaves(ref_like)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # what each rank of data=2 (FSDP) held, and restored at model=2
    _, saved = _state_specs(Mesh.of((2, 1), ("data", "model")), True)
    _, restored = _state_specs(Mesh.of((1, 2), ("data", "model")), False)
    for arrays, res in out[2]:
        assert res["restored_step"] == 1
        for n, leaf in enumerate(one):
            np.testing.assert_array_equal(
                arrays[f"saved/{n}"],
                local_shard(leaf, saved[n], Mesh.of((2, 1), ("data", "model")),
                            res["saved_coords"]).numpy())
            np.testing.assert_array_equal(
                arrays[f"restored/{n}"],
                local_shard(leaf, restored[n],
                            Mesh.of((1, 2), ("data", "model")),
                            res["restored_coords"]).numpy())
    # rank 0 alone wrote, in the reference's layout
    files = sorted(p.name for p in (root / "save_ck" / "step_000000000001")
                   .iterdir())
    assert files == ["meta.json", "proc_000.npz"]


def _ref_like():
    """The reference's train state structure (abstract)."""
    cfg = ref_reduced_config("qwen1_5_4b").reduced(**WIDE)
    model = ref_build_model(cfg)
    return jax.eval_shape(lambda: ref_step.init_train_state(
        model, RefOptConfig(**OPT), jax.random.PRNGKey(0))[0])


def test_reference_checkpoint_restores_onto_a_port_mesh(spawned):
    _, _, ref_state, out = spawned
    mesh = Mesh.of((1, 2), ("data", "model"))
    _, specs = _state_specs(mesh, False)
    for arrays, res in out[2]:
        assert res["from_ref_step"] == 1
        for n, (leaf, sp) in enumerate(zip(jax.tree.leaves(ref_state),
                                           specs)):
            np.testing.assert_array_equal(
                arrays[f"from_ref/{n}"],
                local_shard(np.asarray(leaf), sp, mesh,
                            res["restored_coords"]))


def test_elastic_resume_continues_the_uninterrupted_run(spawned, tmp_path):
    _, params, _, out = spawned
    total, fail_at = RESUME
    for _, res in out[4]:
        assert res["failed"] == fail_at
    model = build_model(_cfg())
    whole = run(model, ShapeSpec("t", *SHAPE, "train"),
                LoopConfig(total_steps=total, ckpt_every=100,
                           ckpt_dir=str(tmp_path / "ck")),
                OptConfig(**OPT), device="cpu",
                params=params_from_numpy(_nest(params), "cpu"))
    for _, res in out[2]:
        r = res["resume"]
        assert r["resumed_from"] == fail_at
        assert r["mesh"] == {"data": 1, "model": 2}
        np.testing.assert_allclose(r["losses"], whole.losses[fail_at:],
                                   rtol=1e-5)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree
