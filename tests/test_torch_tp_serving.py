"""Tensor-parallel serving on the port (gloo, CPU) against the
reference's single-device Engine.

The reduced qwen1.5-4b widened as the main path's (d_model 512, d_ff
1024, 4 heads of 128), fp32, 2 layers.  The parent builds the
reference's params and serves them on the reference's ``Engine``; ranks
spawned over a file store in ``tmp_path`` each carry their pieces of
the same params (``params_from_numpy``'s sharded form), run ``install
--mesh``'s sweep, serve the same groups and queue on ``Engine(mesh=)``
and write their results.  Checks: tokens equal, logits within
``F32_TOL`` (1e-4 + 1e-4 |ref|), 0 registry misses after the install,
only the rank's pieces held, and one decode call's collectives equal to
the contract derived from the shapes: per layer an all-reduce after
``wo`` and one after ``w_down``, one after the vocab-sharded lookup, one
all-gather of the logits.  Then the launcher under torchrun.
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
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import Engine as RefEngine
from repro.serve.scheduler import Request as RefRequest

REPO = Path(__file__).resolve().parents[1]
WIDE = dict(d_model=512, d_ff=1024, num_heads=4, num_kv_heads=4,
            head_dim=128, dtype="float32")
F32_TOL = 1e-4
TIMEOUT = 240
GROUPS = ((1, 16, 0), (3, 16, 1))           # batch, prompt, seed
STEPS = 4
QUEUE = ((5, 3), (12, 2), (9, 4), (16, 3))  # prompt, max_new_tokens
MAX_LEN = 64

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core import registry
    from repro_torch.core.install import install_arch, parse_mesh
    from repro_torch.core.packing import PackedTensor
    from repro_torch.core.plan import length_buckets_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.param import MetaGenerator, params_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request

    rank, world, out, spec = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    cfg_in = json.load(open(os.path.join(out, "cfg.json")))
    buckets = tuple(cfg_in["buckets"])
    cfg = get_reduced_config("qwen1_5_4b").reduced(**cfg_in["wide"])
    desc = parse_mesh(spec)
    mesh = make_mesh(tuple(desc.shape.values()), desc.axis_names,
                     device="cpu", rank=rank, world_size=world,
                     init_file=os.path.join(out, "store"), verbose=False)
    install_arch(cfg, buckets, length_buckets_for(16), mesh=desc,
                 device="cpu")
    registry.flush()
    misses0 = registry.stats()["misses"]

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
    params = params_from_numpy(tree, "cpu", mesh=mesh, axes=axes)
    eng = Engine(model, params, axes, max_len=cfg_in["max_len"],
                 buckets=buckets, max_prompt=16, device="cpu", mesh=mesh)
    res = {"backend": mesh.backend, "graphed": eng.programs.stats()["graphed"],
           "packed": {k: list(v) for k, v in eng.pack_report.items()},
           "wq_cols": eng.params["layers"]["attn"]["wq"].shape[-1],
           "tok_rows": eng.params["embed"]["tok"].shape[0],
           "packed_wq": isinstance(eng.params["layers"]["attn"]["wq"],
                                   PackedTensor)}
    arrays = {}
    for b, plen, seed in cfg_in["groups"]:
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (b, plen)).astype(np.int32)
        got = eng.generate({"tokens": torch.from_numpy(toks)},
                           cfg_in["steps"])
        arrays[f"tokens_{b}"] = got.tokens.numpy()
        arrays[f"logits_{b}"] = got.logits_last.numpy()
        res[f"buckets_{b}"] = list(got.buckets)
        res[f"decode_{b}"] = eng.collectives("decode", got.buckets[0])
    rng = np.random.default_rng(7)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(cfg_in["queue"])]
    results, stats = eng.serve_queue(reqs)
    for r in results:
        arrays[f"queue_{r.rid}"] = np.asarray(r.tokens)
    res["admitted"] = stats.admitted
    res["misses"] = registry.stats()["misses"] - misses0
    res["healthy"] = eng.health_report()["healthy"]
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
def reference(tmp_path_factory):
    """The reference's params, its single-device Engine's groups and
    queue."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PLAN_CACHE",
              str(tmp_path_factory.mktemp("ref_plans") / "plans.json"))
    ref_registry.clear_memory()
    cfg = ref_reduced_config("qwen1_5_4b").reduced(**WIDE)
    model = ref_build_model(cfg)
    params, axes = model.init(jax.random.PRNGKey(0))
    eng = RefEngine(model, params, axes, max_len=MAX_LEN, max_batch=4,
                    max_prompt=16, program_cache=False)
    want = {}
    for b, plen, seed in GROUPS:
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (b, plen)).astype(np.int32)
        r = eng.generate({"tokens": jnp.asarray(toks)}, STEPS)
        want[f"tokens_{b}"] = np.asarray(r.tokens)
        want[f"logits_{b}"] = np.asarray(r.logits_last)
    rng = np.random.default_rng(7)
    reqs = [RefRequest(tokens=rng.integers(0, cfg.vocab_size, n)
                       .astype(np.int32), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(QUEUE)]
    results, _ = eng.serve_queue(reqs)
    for r in results:
        want[f"queue_{r.rid}"] = np.asarray(r.tokens)
    flat = flat_params(jax.tree.map(np.asarray, params))
    yield cfg, flat, want
    mp.undo()
    ref_registry.clear_memory()


def spawn(tmp_path: Path, spec: str, world: int, buckets: tuple,
          flat: dict) -> list:
    np.savez(tmp_path / "params.npz", **flat)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"wide": WIDE, "buckets": buckets, "groups": GROUPS, "steps": STEPS,
         "queue": QUEUE, "max_len": MAX_LEN}))
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


def decode_contract(cfg, rows: int, tp: int) -> dict:
    """One decode call's collectives on a rank, from the shapes: per layer
    an all-reduce of the (rows, 1, d_model) output of ``wo`` and of
    ``w_down``, one of the looked-up embeddings, and one all-gather of
    the (rows, 1, vocab) logits; ring multipliers 2 (n-1)/n and
    (n-1)/n."""
    act = rows * cfg.d_model * 4
    n_ar = 2 * cfg.num_layers + 1
    logits = rows * cfg.vocab_size * 4
    return {"all-reduce": {"count": n_ar, "tensor_bytes": float(n_ar * act),
                           "bytes_moved": n_ar * act * 2 * (tp - 1) / tp},
            "all-gather": {"count": 1, "tensor_bytes": float(logits),
                           "bytes_moved": logits * (tp - 1) / tp}}


@pytest.mark.parametrize("spec,world,buckets", [
    ("model=2", 2, (1, 2, 4)),
    ("data=2,model=2", 4, (2, 4)),
])
def test_tp_engine_matches_the_reference(reference, tmp_path, spec, world,
                                         buckets):
    cfg, flat, want = reference
    ranks = spawn(tmp_path, spec, world, buckets, flat)
    dp = world // 2
    for rank, (out, res) in enumerate(ranks):
        assert res["backend"] == "gloo" and res["graphed"] is False
        # only the rank's pieces: half the heads' columns, half the vocab
        assert res["packed_wq"] and res["wq_cols"] == 256
        assert res["tok_rows"] == cfg.vocab_size // 2
        assert len(res["packed"]) == 8
        assert res["misses"] == 0 and res["healthy"]
        for b, _, _ in GROUPS:
            np.testing.assert_array_equal(out[f"tokens_{b}"],
                                          want[f"tokens_{b}"])
            got, ref = out[f"logits_{b}"], want[f"logits_{b}"]
            assert got.shape == ref.shape
            assert np.all(np.abs(got - ref) <= F32_TOL + F32_TOL * np.abs(ref))
            bucket = res[f"buckets_{b}"][0]
            rows = bucket // dp if bucket % dp == 0 else bucket
            assert res[f"decode_{b}"] == decode_contract(cfg, rows, 2)
        assert res["admitted"] == len(QUEUE)
        for i in range(len(QUEUE)):
            np.testing.assert_array_equal(out[f"queue_{i}"],
                                          want[f"queue_{i}"])


def test_launcher_serves_tensor_parallel_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_TORCH_PLAN_CACHE=str(tmp_path / "plans.json"),
               REPRO_TORCH_MEASURE_CACHE=str(tmp_path / "meas.json"),
               REPRO_TORCH_MISS_LOG=str(tmp_path / "miss.json"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--arch", "qwen1_5_4b", "--reduced", "--device", "cpu",
         "--mesh", "model=2", "--trace", "1,3", "--steps", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "backend=gloo graphed=False" in out.stdout
    assert "group b=   3 -> buckets=(3,)" in out.stdout
    # rank 0 prints alone
    assert out.stdout.count("plan registry:") == 1
    col = json.loads(out.stdout.split("collectives of one decode call: ")[1]
                     .splitlines()[0])
    assert col["all-reduce"]["count"] == 5 and col["all-gather"]["count"] == 1


def test_prepack_for_keys_and_blocks_follow_the_shards(tmp_path, monkeypatch):
    """``prepack_for`` on a mesh: a rank's piece packs alone, bit-equal
    to the piece, its plans keyed by the shard count."""
    import torch
    from repro_torch.core import registry
    from repro_torch.core.tsmm import prepack_for
    for var, name in (("REPRO_TORCH_PLAN_CACHE", "plans.json"),
                      ("REPRO_TORCH_MEASURE_CACHE", "meas.json"),
                      ("REPRO_TORCH_MISS_LOG", "misses.json")):
        monkeypatch.setenv(var, str(tmp_path / name))
    registry.clear_memory()
    w = torch.randn(1024, 1536)
    piece = w[:, :768].contiguous()
    mine = prepack_for((1, 4), piece, num_shards=2)
    keys = set(registry.drain_misses())
    assert keys and all(k.endswith("_s2") and "_k1024_n768_" in k
                        for k in keys)
    torch.testing.assert_close(mine.unpack(), piece, rtol=0, atol=0)
    registry.clear_memory()
