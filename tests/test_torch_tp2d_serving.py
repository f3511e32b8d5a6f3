"""2D weight-stationary tensor parallelism and FSDP serving on the port
(gloo, CPU) against the reference's single-device Engine.

The reduced qwen1.5-4b widened as the main path's (d_model 512, d_ff
1024, 4 heads of 128), fp32, 2 layers, with non-zero QKV biases and
norm scales away from 1 (a bias added once per data rank, or a norm
piece gathered out of order, would show).  Four ranks on a file store
serve it at ``data=2,model=2`` under ``ShardingOptions(fsdp=True,
serve_2d_tp=True)`` and under ``ShardingOptions(fsdp=True)``, each
after ``install_arch(mesh=, opts=)``: a group of 1 (bucket 1: the
rules split the cache along its sequence over ``data``), a group of 3
(bucket 4: the cache's rows on ``data``) and the queue; then the group
of 3 again on an engine that leaves every piece unpacked.  Checks: tokens
equal, logits within ``F32_TOL`` (1e-4 + 1e-4 |ref|), 0 registry misses,
only the rank's pieces held, one decode call's collectives equal to the
contract derived from the shapes (:func:`decode_contract`), and the 2D
decode moving strictly fewer bytes than the FSDP one.
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
from repro_torch.analysis.collectives import bytes_moved

REPO = Path(__file__).resolve().parents[1]
WIDE = dict(d_model=512, d_ff=1024, num_heads=4, num_kv_heads=4,
            head_dim=128, dtype="float32")
F32_TOL = 1e-4
TIMEOUT = 240
BUCKETS = (1, 2, 4)
GROUPS = ((1, 16, 0), (3, 16, 1))           # batch, prompt, seed
STEPS = 4
QUEUE = ((5, 3), (12, 2), (9, 4), (16, 3))  # prompt, max_new_tokens
# a 16-token prompt fills the first data rank's 16 slots of a
# sequence-split cache; every decode step lands in the second's
MAX_LEN = 32
MODES = {"tp2d": dict(fsdp=True, serve_2d_tp=True), "fsdp": dict(fsdp=True)}

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core import registry
    from repro_torch.core.install import install_arch, parse_mesh
    from repro_torch.core.plan import length_buckets_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.param import MetaGenerator, params_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request
    from repro_torch.sharding.rules import ShardingOptions

    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    cfg_in = json.load(open(os.path.join(out, "cfg.json")))
    buckets = tuple(cfg_in["buckets"])
    cfg = get_reduced_config("qwen1_5_4b").reduced(**cfg_in["wide"])
    desc = parse_mesh("data=2,model=2")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu", rank=rank,
                     world_size=world, init_file=os.path.join(out, "store"),
                     verbose=False)
    modes = {k: ShardingOptions(**v) for k, v in cfg_in["modes"].items()}
    for opts in modes.values():
        install_arch(cfg, buckets, length_buckets_for(16), mesh=desc,
                     opts=opts, device="cpu")
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
    res, arrays = {}, {}
    for name, opts in modes.items():
        params = params_from_numpy(tree, "cpu", mesh=mesh, axes=axes,
                                   opts=opts)
        eng = Engine(model, params, axes, max_len=cfg_in["max_len"],
                     buckets=buckets, max_prompt=16, device="cpu",
                     mesh=mesh, opts=opts)
        p = eng.params
        r = {"packed": {k: list(v) for k, v in eng.pack_report.items()},
             "wq": list(p["layers"]["attn"]["wq"].shape),
             "tok": list(p["embed"]["tok"].shape),
             "ln1": list(p["layers"]["ln1"].shape)}
        for b, plen, seed in cfg_in["groups"]:
            toks = np.random.default_rng(seed).integers(
                0, cfg.vocab_size, (b, plen)).astype(np.int32)
            got = eng.generate({"tokens": torch.from_numpy(toks)},
                               cfg_in["steps"])
            arrays[f"{name}_tokens_{b}"] = got.tokens.numpy()
            arrays[f"{name}_logits_{b}"] = got.logits_last.numpy()
            r[f"buckets_{b}"] = list(got.buckets)
            r[f"decode_{b}"] = eng.collectives("decode", got.buckets[0])
        rng = np.random.default_rng(7)
        reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, n)
                        .astype(np.int32), max_new_tokens=m, rid=i)
                for i, (n, m) in enumerate(cfg_in["queue"])]
        results, stats = eng.serve_queue(reqs)
        for q in results:
            arrays[f"{name}_queue_{q.rid}"] = np.asarray(q.tokens)
        r["admitted"] = stats.admitted
        r["healthy"] = eng.health_report()["healthy"]
        res[name] = r
        del eng, params
    res["misses"] = registry.stats()["misses"] - misses0
    # unpacked pieces (every leaf gathered over data before use, or its
    # columns computed where 2D leaves them), the group of 3
    b, plen, seed = cfg_in["groups"][-1]
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, plen)).astype(np.int32)
    for name, opts in modes.items():
        eng = Engine(model, params_from_numpy(tree, "cpu", mesh=mesh,
                                              axes=axes, opts=opts),
                     axes, max_len=cfg_in["max_len"], buckets=buckets,
                     max_prompt=16, device="cpu", mesh=mesh, opts=opts,
                     prepack=False)
        got = eng.generate({"tokens": torch.from_numpy(toks)},
                           cfg_in["steps"])
        arrays[f"{name}_unpacked_tokens_{b}"] = got.tokens.numpy()
        arrays[f"{name}_unpacked_logits_{b}"] = got.logits_last.numpy()
        del eng
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


def nest(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's params (QKV biases and norm scales seeded away
    from their init), its single-device Engine's groups and queue."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PLAN_CACHE",
              str(tmp_path_factory.mktemp("ref_plans") / "plans.json"))
    ref_registry.clear_memory()
    cfg = ref_reduced_config("qwen1_5_4b").reduced(**WIDE)
    model = ref_build_model(cfg)
    params, axes = model.init(jax.random.PRNGKey(0))
    flat = flat_params(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(11)
    for key in list(flat):
        leaf = key.split("/")[-1]
        if leaf in ("bq", "bk", "bv"):
            flat[key] = (0.5 * rng.standard_normal(flat[key].shape)
                         ).astype(flat[key].dtype)
        elif leaf in ("ln1", "ln2", "final_norm"):
            flat[key] = (1 + 0.2 * rng.standard_normal(flat[key].shape)
                         ).astype(flat[key].dtype)
    params = jax.tree.map(jnp.asarray, nest(flat))
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
    yield cfg, flat, want
    mp.undo()
    ref_registry.clear_memory()


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """The four ranks' results, both modes."""
    _, flat, _ = reference
    tmp = tmp_path_factory.mktemp("tp2d")
    np.savez(tmp / "params.npz", **flat)
    (tmp / "cfg.json").write_text(json.dumps(
        {"wide": WIDE, "buckets": BUCKETS, "groups": GROUPS, "steps": STEPS,
         "queue": QUEUE, "max_len": MAX_LEN, "modes": MODES}))
    script = tmp / "worker.py"
    script.write_text(WORKER)
    procs = []
    for r in range(4):
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   REPRO_TORCH_PLAN_CACHE=str(tmp / f"plans{r}.json"),
                   REPRO_TORCH_MEASURE_CACHE=str(tmp / f"meas{r}.json"),
                   REPRO_TORCH_MISS_LOG=str(tmp / f"miss{r}.json"),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(r), "4", str(tmp)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
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
    return [(np.load(tmp / f"out_{r}.npz"),
             json.loads((tmp / f"res_{r}.json").read_text()))
            for r in range(4)]


def _op(count: int, tensor: float, factor: float) -> dict:
    return {"count": count, "bytes_moved": tensor * factor,
            "tensor_bytes": float(tensor)}


def decode_contract(cfg, mode: str, bucket: int, packed: dict,
                    data: int = 2, model: int = 2, itemsize: int = 4) -> dict:
    """One decode call's collectives on a rank, from the shapes and the
    rank's packed block shapes (``packed``: the engine's pack report).
    Ring multipliers: all-reduce 2 (n-1)/n, all-gather (n-1)/n; all-gather
    bytes are its output's.

    Both modes gather each norm's scale (2 a layer and the final one) and
    the looked-up embedding's columns over ``data``, and all-reduce the
    lookup over ``model``; a bucket the data axis cannot split keeps its
    cache's sequence on ``data``, and each layer's decode attention
    gathers its fp32 (max, sum, weighted V) over it.
    * 2D (every rank computes the bucket): an all-reduce over ``data`` of
      each k-split product (wq, wk, wv, w_gate, w_up, the head), one over
      ``model`` after wo and w_down, whose columns are then gathered over
      ``data``; with the cache's rows on ``data`` the attention output is
      gathered over it; the logits gathered over ``model``.
    * FSDP (each data line computes its rows, or all of a bucket the data
      axis cannot split): the ids gathered over ``data`` first (the
      lookup runs over every line's rows); every packed weight gathered
      over ``data`` before its product; an all-reduce over ``model``
      after wo and w_down; the logits gathered over ``model``."""
    d, q = cfg.d_model, cfg.num_heads * cfg.head_dim
    kv, f, v, L = (cfg.num_kv_heads * cfg.head_dim, cfg.d_ff, cfg.vocab_size,
                   cfg.num_layers)
    ar, ag = 2 * (data - 1) / data, (data - 1) / data
    assert data == model                     # one factor for both axes
    e = itemsize
    seq = bucket < data
    rows = bucket if mode == "tp2d" or seq else bucket // data
    reduce, gather = [], []
    partials = data * rows * (cfg.num_heads // model) * (cfg.head_dim + 2) * 4
    if mode == "tp2d":
        reduce += [rows * d // data * e]                   # lookup
        gather += [rows * d * e]                           # its columns
        for _ in range(L):
            gather += [d * e]                              # ln1
            reduce += [rows * q // model * e, rows * kv // model * e,
                       rows * kv // model * e]             # wq, wk, wv
            gather += [partials if seq else rows * q // model * e]
            reduce += [rows * d // data * e]               # wo over model
            gather += [rows * d * e, d * e]                # its cols, ln2
            reduce += [rows * f // model * e] * 2          # w_gate, w_up
            reduce += [rows * d // data * e]               # w_down
            gather += [rows * d * e]                       # its columns
        gather += [d * e]                                  # final norm
        reduce += [rows * v // model * e]                  # the head
        gather += [rows * v * e]                           # the logits
    else:
        def blocks(leaf):
            return int(np.prod(packed[leaf][-4:])) * data * e
        lead = "layers/attn/", "layers/mlp/"
        gather += [data * rows * 4, data * rows * d * e]   # ids, lookup
        reduce += [data * rows * d // data * e]
        for _ in range(L):
            gather += [d * e] + [blocks(lead[0] + w) for w in
                                 ("wq", "wk", "wv")]
            if seq:
                gather += [partials]
            gather += [blocks(lead[0] + "wo")]
            reduce += [rows * d * e]                       # wo over model
            gather += [d * e] + [blocks(lead[1] + w) for w in
                                 ("w_gate", "w_up", "w_down")]
            reduce += [rows * d * e]                       # w_down
        gather += [d * e, blocks("embed/head"), rows * v * e]
    return {"all-reduce": _op(len(reduce), sum(reduce), ar),
            "all-gather": _op(len(gather), sum(gather), ag)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sharded_engine_matches_the_reference(reference, ranks, mode):
    cfg, _, want = reference
    for rank, (out, all_res) in enumerate(ranks):
        res = all_res[mode]
        assert all_res["misses"] == 0 and res["healthy"]
        # only the rank's pieces: rows on data, columns on model
        assert res["wq"] == [cfg.num_layers, 256, 256]
        assert res["tok"] == [cfg.vocab_size // 2, cfg.d_model // 2]
        assert res["ln1"] == [cfg.num_layers, cfg.d_model // 2]
        assert len(res["packed"]) == 8
        for b, _, _ in GROUPS:
            np.testing.assert_array_equal(out[f"{mode}_tokens_{b}"],
                                          want[f"tokens_{b}"])
            got, ref = out[f"{mode}_logits_{b}"], want[f"logits_{b}"]
            assert got.shape == ref.shape
            assert np.all(np.abs(got - ref) <= F32_TOL + F32_TOL * np.abs(ref))
            bucket = res[f"buckets_{b}"][0]
            assert res[f"decode_{b}"] == decode_contract(
                cfg, mode, bucket, res["packed"]), (rank, b)
        assert res["admitted"] == len(QUEUE)
        for i in range(len(QUEUE)):
            np.testing.assert_array_equal(out[f"{mode}_queue_{i}"],
                                          want[f"queue_{i}"])
        b = GROUPS[-1][0]
        np.testing.assert_array_equal(out[f"{mode}_unpacked_tokens_{b}"],
                                      want[f"tokens_{b}"])
        got, ref = out[f"{mode}_unpacked_logits_{b}"], want[f"logits_{b}"]
        assert np.all(np.abs(got - ref) <= F32_TOL + F32_TOL * np.abs(ref))


@pytest.mark.parametrize("b", [g[0] for g in GROUPS])
def test_2d_decode_moves_fewer_bytes_than_fsdp(reference, ranks, b):
    """The reference's ``test_serve_2d_tp_reduces_collectives_on_8dev``
    property, strict: weights that never move against weights gathered
    per call."""
    for _, res in ranks:
        tp2d = bytes_moved(res["tp2d"][f"decode_{b}"])
        fsdp = bytes_moved(res["fsdp"][f"decode_{b}"])
        assert 0 < tp2d < fsdp, (b, tp2d, fsdp)
