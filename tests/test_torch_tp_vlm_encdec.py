"""The LLaVA-NeXT backbone and whisper-base under tensor parallelism
(gloo, CPU) against the reference.

Reduced LLaVA (GQA: 4 query and 2 KV heads of 128, 8 image embeddings
ahead of the tokens) and whisper (4 heads of 128, 2 encoder and 2 decoder
layers over 16 frames, an odd vocabulary of 517 as the published 51865 is
odd), widened to d_model 512 so every projection and the head pack,
fp32.  The embeddings and frames are seeded fp32 values on the bf16 grid
(both engines feed them in bf16).  The parent builds the reference's
params and serves them on the reference's single-device ``Engine``; for
each mesh one spawn of ranks over a file store serves both archs on
``Engine(mesh=)`` from their pieces after ``install --mesh``:

* ``model=2``: each rank its heads (one KV head of LLaVA, the cross cache's
  heads of whisper) and MLP columns, LLaVA's half of the vocabulary,
  whisper's whole;
* ``data=2,model=2`` over 4 ranks: bucket 2 splits its rows (tokens,
  image embeddings, frames) over ``data``; bucket 1 is computed whole on
  every rank (the self-attention slots split over ``data``).

Checks: tokens equal and logits within ``F32_TOL`` (1e-4 + 1e-4 |ref|),
0 registry misses, the packed pieces equal to ``sharded_serving_shapes``,
the cross cache's heads, one decode call's collectives equal to the
contract from the shapes; on ``model=2`` ``cross_decode`` on each rank's
heads against the reference's on every head; the rows a rank's prefill
runs (``rank_prefill_rows``: image embeddings and tokens, the encoder's
frames) and the sweep's plans of a piece too small to pack at them.
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
from repro.models import attention as ref_A
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import Engine as RefEngine
from repro_torch.configs.base import get_reduced_config
from repro_torch.core.install import (parse_mesh, rank_prefill_rows,
                                      sharded_serving_shapes)
from repro_torch.core.plan import is_tsmm, length_buckets_for

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("llava_next_mistral_7b", "whisper_base")
WIDE = {
    "llava_next_mistral_7b": dict(d_model=512, num_heads=4, num_kv_heads=2,
                                  head_dim=128, d_ff=1024),
    "whisper_base": dict(d_model=512, num_heads=4, num_kv_heads=4,
                         head_dim=128, d_ff=1024, vocab_size=517),
}
F32_TOL = 1e-4
TIMEOUT = 300
GROUPS = ((1, 16, 3), (2, 16, 4))      # batch, prompt tokens, seed
STEPS = 3
MAX_LEN = 32
BUCKETS = (1, 2)
# spec -> world
MESHES = {"model=2": 2, "data=2,model=2": 4}


def cfg_pair(arch: str):
    over = dict(WIDE[arch], dtype="float32")
    return (ref_reduced_config(arch).reduced(**over),
            get_reduced_config(arch).reduced(**over))


def bf16_grid(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def group(cfg, b: int, plen: int, seed: int) -> dict:
    """A group's inputs: its tokens and its image embeddings or frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (b, plen)).astype(np.int32)}
    if cfg.embeds_input:
        out["embeds"] = bf16_grid(rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
    if cfg.is_encoder_decoder:
        out["enc_frames"] = bf16_grid(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


def cross_inputs(cfg) -> tuple:
    """The cross-attention check's step input (2, 1, d) and cross K/V
    (2, T, KH, D)."""
    rng = np.random.default_rng(31)
    kv = (2, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    return (rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32),
            rng.standard_normal(kv).astype(np.float32),
            rng.standard_normal(kv).astype(np.float32))


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
    from repro_torch.models import attention as A
    from repro_torch.models.lm import layer_params
    from repro_torch.models.param import MetaGenerator, params_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding.context import sharding_ctx

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
        r = {}
        if cfg_in["module"] and cfg.is_encoder_decoder:
            # cross_decode on the rank's heads of wq / wo and of the cross
            # cache, against the reference's on every head
            x, ck, cv = (torch.from_numpy(a) for a in np.load(
                os.path.join(out, "cross.npz")).values())
            p0 = layer_params(params["dec_layers"], 0)["cross_attn"]
            kh = p0["wk"].shape[-1] // cfg.head_dim
            mine = slice(rank * kh, (rank + 1) * kh)
            with torch.inference_mode(), sharding_ctx(mesh):
                y = A.cross_decode(p0, cfg, x, ck[:, :, mine].contiguous(),
                                   cv[:, :, mine].contiguous())
            arrays[f"{arch}_cross"] = y.numpy()
        eng = Engine(model, params, axes, max_len=cfg_in["max_len"],
                     buckets=buckets, max_prompt=16, device="cpu", mesh=mesh)
        r["packed"] = sorted(eng.pack_report)
        r["pieces"] = sorted({tuple(t.shape[-2:]) for _, t in
                              leaves(eng.params) if is_packed(t)})
        r["shapes"] = sorted((k, n) for k, n, _ in
                             sharded_serving_shapes(cfg, desc))
        cache = eng.programs.static_cache(1, cfg_in["max_len"])
        r["cache"] = {k: list(v.shape) for k, v in cache.items()}
        r["layouts"] = {str(b): repr(eng.cache_layout(b)) for b in buckets}
        for b, plen, seed in cfg_in["groups"]:
            g = np.load(os.path.join(out, f"group_{arch}_{b}.npz"))
            got = eng.generate({k: torch.from_numpy(g[k]) for k in g.files},
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
    """The reference's params, its single-device Engine's groups, and
    whisper's ``cross_decode`` of the first decoder layer on
    ``cross_inputs``."""
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
        g = group(cfg, b, plen, seed)
        want[f"group_{b}"] = g
        r = eng.generate({k: jnp.asarray(v) for k, v in g.items()}, STEPS)
        want[f"tokens_{b}"] = np.asarray(r.tokens)
        want[f"logits_{b}"] = np.asarray(r.logits_last)
    if cfg.is_encoder_decoder:
        p0 = jax.tree.map(lambda a: a[0], params["dec_layers"])["cross_attn"]
        x, ck, cv = cross_inputs(cfg)
        want["cross"] = np.asarray(ref_A.cross_decode(
            p0, ref_cfg, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv)))
    want["flat"] = flat_params(jax.tree.map(np.asarray, params))
    _REFS[arch] = (cfg, want)
    return _REFS[arch]


def spawn(tmp_path: Path, spec: str, world: int) -> list:
    over = {}
    for arch in ARCHS:
        cfg, want = reference(arch)
        np.savez(tmp_path / f"params_{arch}.npz", **want["flat"])
        for b, _, _ in GROUPS:
            np.savez(tmp_path / f"group_{arch}_{b}.npz", **want[f"group_{b}"])
        over[arch] = dict(WIDE[arch], dtype="float32")
        if cfg.is_encoder_decoder:
            np.savez(tmp_path / "cross.npz", *cross_inputs(cfg))
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


def decode_contract(cfg, rows: int, seq_split: bool) -> dict:
    """One decode call's collectives on a rank computing ``rows`` rows,
    fp32, every group of 2 ranks: per layer ``wo``'s and the MLP's
    all-reduce (and whisper's cross-attention ``wo``); where the
    self-attention slots are split over the data axis (a whole bucket on
    a data mesh), per layer the softmax partials' all-gather (every local
    head's (m, l, acc)); where the vocabulary splits (LLaVA's, not
    whisper's odd one), the lookup's all-reduce and the logits'
    all-gather."""
    d, f = cfg.d_model, 4
    vocab_split = cfg.vocab_size % 2 == 0
    ar = [rows * d * f] if vocab_split else []
    ag = [rows * cfg.vocab_size * f] if vocab_split else []
    kh = cfg.num_kv_heads // 2
    g = cfg.num_heads // cfg.num_kv_heads
    for _ in range(cfg.num_layers):
        ar += [rows * d * f] * (3 if cfg.is_encoder_decoder else 2)
        if seq_split:
            ag.append(2 * rows * kh * g * (2 + cfg.head_dim) * f)
    out = {"all-reduce": {"count": len(ar), "bytes_moved": float(sum(ar)),
                          "tensor_bytes": float(sum(ar))}}
    if ag:
        out["all-gather"] = {"count": len(ag),
                             "bytes_moved": float(sum(ag)) / 2,
                             "tensor_bytes": float(sum(ag))}
    return out


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.abs(got - want) <= F32_TOL + F32_TOL * np.abs(want)), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("spec", list(MESHES))
def test_vlm_encdec_tp_engine_matches_the_reference(ref_env, tmp_path,
                                                    spec):
    world = MESHES[spec]
    ranks = spawn(tmp_path, spec, world)
    dp = world // 2
    for arch in ARCHS:
        cfg, want = reference(arch)
        for rank, (out, allres) in enumerate(ranks):
            res = allres[arch]
            assert res["misses"] == 0 and res["healthy"], res
            assert res["pieces"] == res["shapes"], (res["pieces"],
                                                    res["shapes"])
            assert "embed/head" in res["packed"]
            kv = [cfg.num_layers, 1, MAX_LEN, cfg.num_kv_heads // 2,
                  cfg.head_dim]
            if dp > 1:
                kv[2] //= 2            # bucket 1: its slots over data
            assert res["cache"]["k"] == kv
            if cfg.is_encoder_decoder:
                # the odd vocabulary whole, the cross cache's heads split
                assert [cfg.d_model, cfg.vocab_size] in res["pieces"]
                assert res["cache"]["cross_k"] == [
                    cfg.num_layers, 1, cfg.encoder_seq,
                    cfg.num_kv_heads // 2, cfg.head_dim]
            else:
                assert [cfg.d_model, cfg.vocab_size // 2] in res["pieces"]
            for b, _, _ in GROUPS:
                np.testing.assert_array_equal(out[f"{arch}_tokens_{b}"],
                                              want[f"tokens_{b}"])
                _close(out[f"{arch}_logits_{b}"], want[f"logits_{b}"])
                bucket = res[f"buckets_{b}"][0]
                split_rows = dp > 1 and bucket % dp == 0
                rows = bucket // dp if split_rows else bucket
                assert res[f"decode_{b}"] == decode_contract(
                    cfg, rows, seq_split=dp > 1 and not split_rows), (arch, b)
            if world == 2 and cfg.is_encoder_decoder:
                _close(out[f"{arch}_cross"], want["cross"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", list(MESHES))
def test_the_sweep_plans_the_rows_a_rank_prefills(arch, spec):
    """A rank's prefill runs its compute rows of each cell: bucket x
    prompt, LLaVA's bucket x (image embeddings + prompt), whisper's
    bucket x frames (its data line's row where ``data`` splits the
    bucket).  The sweep plans a piece too small to pack (LLaVA's (512,
    128) ``wk`` / ``wv``) at each of them and at the decode rows, keyed
    as an unpacked product looks it up (one shard); a packed piece
    (every whisper leaf's) only at its buckets."""
    _, cfg = cfg_pair(arch)
    mesh = parse_mesh(spec)
    lengths = length_buckets_for(16)
    dp = mesh.shape.get("data", 1)
    rows = {1: 1, 2: 2 // dp}
    want = set()
    for bb in BUCKETS:
        for lb in lengths:
            want.add(rows[bb] * lb)
            if cfg.embeds_input:
                want.add(rows[bb] * (cfg.num_image_tokens + lb))
            if cfg.is_encoder_decoder:
                want.add(rows[bb] * cfg.encoder_seq)
    assert rank_prefill_rows(cfg, BUCKETS, lengths, mesh) == sorted(want)
    got = sharded_serving_shapes(cfg, mesh, buckets=BUCKETS, lengths=lengths)
    if cfg.embeds_input:
        kv = (cfg.d_model, cfg.num_kv_heads * cfg.head_dim // 2)
        planned = [m for m in want | set(rows.values()) if is_tsmm(m, *kv)]
        assert planned
        assert all((m, *kv, 1) in got for m in planned)
    else:
        assert {m for m, _, _, s in got if s == 1} <= set(BUCKETS)
