"""The LLaVA-NeXT backbone and whisper-base under 2D weight-stationary
tensor parallelism and FSDP serving (gloo, CPU) against the reference's
single-device Engine.

Reduced LLaVA (GQA: 4 query and 2 KV heads of 128, 8 image embeddings
ahead of the tokens) and whisper (4 heads of 128, 2 encoder and 2 decoder
layers over 16 frames, an odd vocabulary of 517), widened to d_model 512
as in ``test_torch_tp_vlm_encdec.py``, fp32.  Their norms and whisper's
MLP biases are seeded away from their init (ones, zeros), so a bias added
once per data rank, or a norm piece gathered out of order, would show.
For each layout one spawn of four ranks over a file store,
``data=2,model=2``, serves both archs on ``Engine(mesh=, opts=)`` from
their pieces (``params_from_numpy``'s sharded form) after
``install_arch(mesh=, opts=)``:

* ``ShardingOptions(fsdp=True, serve_2d_tp=True)`` (2D): every rank
  computes the whole bucket (its image embeddings and frames included)
  over pieces that never move: each projection whose rows lie on
  ``data`` (``wq`` / ``wk`` / ``wv``, ``w_gate`` / ``w_up``, whisper's
  ``w_in`` with its bias and GELU after the sum, the head) contracted
  over the rank's K slice and summed over ``data``; ``wo``'s, ``w_down``'s
  and ``w_out``'s columns gathered over it (``b_out``'s piece added on the
  first ``model`` rank); at bucket 2 the self-attention and cross caches'
  rows on ``data``, at bucket 1 the self-attention slots on ``data`` and
  the cross cache whole;
* ``ShardingOptions(fsdp=True)`` (FSDP): each piece gathered over ``data``
  before use (the LayerNorm biases and ``b_out`` too), each data line
  computing its rows.

Checks: tokens equal and logits within ``F32_TOL`` (1e-4 + 1e-4 |ref|) at
buckets 1 and 2, 0 registry misses, only the rank's pieces held, one
decode call's collectives equal to the contract from the shapes, no
weight gathered in a 2D decode call and 2D moving fewer bytes than FSDP;
and ``cross_decode``, ``gelu_mlp`` and ``layernorm`` on the rank's pieces
under each layout's cell layout against the reference's whole modules.
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
from repro.models import attention as ref_A
from repro.models import layers as ref_L
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import Engine as RefEngine
from repro_torch.analysis.collectives import bytes_moved
from test_torch_tp_vlm_encdec import (ARCHS, BUCKETS, F32_TOL, GROUPS,
                                      MAX_LEN, STEPS, WIDE, cfg_pair,
                                      cross_inputs, flat_params, group)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300
LAYOUTS = {"2d": dict(fsdp=True, serve_2d_tp=True), "fsdp": dict(fsdp=True)}
MODULE_X = (2, 4)                      # the module checks' (rows, tokens)
# the stacks a layer-stacked leaf lies in
STACKS = ("layers", "enc_layers", "dec_layers")


WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core import registry
    from repro_torch.core.install import (install_arch, parse_mesh,
                                          sharded_serving_shapes)
    from repro_torch.core.linear import serving_ctx
    from repro_torch.core.packing import is_packed
    from repro_torch.core.plan import length_buckets_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention as A
    from repro_torch.models.layers import gelu_mlp, layernorm
    from repro_torch.models.lm import layer_params
    from repro_torch.models.param import MetaGenerator, params_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding.context import CacheLayout, sharding_ctx
    from repro_torch.sharding.rules import ShardingOptions

    rank, world, out, layout = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    cfg_in = json.load(open(os.path.join(out, "cfg.json")))
    opts = ShardingOptions(**cfg_in["layouts"][layout])
    buckets = tuple(cfg_in["buckets"])
    stacks = tuple(cfg_in["stacks"])
    desc = parse_mesh("data=2,model=2")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu", rank=rank,
                     world_size=world, init_file=os.path.join(out, "store"),
                     verbose=False)
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
                     opts=opts, device="cpu")
        registry.flush()
        model = build_model(cfg)
        axes = model.init(MetaGenerator())[1]
        params = params_from_numpy(tree_of(os.path.join(
            out, f"params_{arch}.npz")), "cpu", mesh=mesh, axes=axes,
            opts=opts, cfg=cfg)
        r = {"pieces": {"/".join(k): list(v.shape) for k, v in leaves(params)
                        if k[-1] in ("wq", "wk", "wo", "w_in", "b_in",
                                     "w_out", "b_out", "w_gate", "w_down",
                                     "tok", "head", "ln1", "ln1_s", "ln1_b",
                                     "enc_norm_b", "final_norm")}}
        i = mesh.coords["data"]
        if cfg.is_encoder_decoder:
            # the modules on the rank's pieces in a cell whose cross cache's
            # rows lie on data: 2D computes the whole bucket (its rows of
            # the cache), FSDP a data line's rows
            m = np.load(os.path.join(out, "module.npz"))
            x, cx, ck, cv = (torch.from_numpy(m[k]) for k in
                             ("x", "cx", "ck", "cv"))
            lp = layer_params(params["dec_layers"], 0)
            j = mesh.coords["model"]
            kh = lp["cross_attn"]["wk"].shape[-1] // cfg.head_dim
            heads = slice(j * kh, (j + 1) * kh)
            ck, cv = (t[i:i + 1, :, heads].contiguous() for t in (ck, cv))
            if opts.serve_2d_tp:
                lay = CacheLayout(rows="data", gathered=True)
            else:
                lay = CacheLayout(rows="data")
                x, cx = x[i:i + 1], cx[i:i + 1]
            with torch.inference_mode(), serving_ctx(), \\
                    sharding_ctx(mesh, opts, layout=lay):
                arrays[f"{arch}_mod_cross"] = A.cross_decode(
                    lp["cross_attn"], cfg, cx, ck, cv).numpy()
                arrays[f"{arch}_mod_mlp"] = gelu_mlp(
                    lp["mlp"], x, cfg.d_ff, cfg.d_model).numpy()
                arrays[f"{arch}_mod_ln"] = layernorm(
                    x, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps).numpy()
        # the engine's misses (the module checks' unpacked products look
        # up shapes no engine runs)
        misses0 = registry.stats()["misses"]
        eng = Engine(model, params, axes, max_len=cfg_in["max_len"],
                     buckets=buckets, max_prompt=16, device="cpu", mesh=mesh,
                     opts=opts)
        r["packed"] = {k: list(v) for k, v in eng.pack_report.items()}
        r["packed_pieces"] = sorted({tuple(t.shape[-2:]) for _, t in
                                     leaves(eng.params) if is_packed(t)})
        r["shapes"] = sorted((k, n) for k, n, _ in
                             sharded_serving_shapes(cfg, desc, opts))
        r["cache"] = {str(b): {k: list(v.shape) for k, v in
                               eng.programs.static_cache(
                                   b, cfg_in["max_len"]).items()}
                      for b in buckets}
        r["layouts"] = {str(b): repr(eng.cache_layout(b)) for b in buckets}
        # the bytes of every weight piece of two dims or more a layer
        # (packed blocks or unpacked) gathered over data
        pieces = set()

        def walk(t, lead):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, lead or k in stacks)
                return
            t = getattr(t, "blocks", t)
            if t.ndim - lead >= 2:
                n = t.numel() // (t.shape[0] if lead else 1)
                pieces.add(2 * n * t.element_size())

        walk(eng.params, False)
        for b, plen, seed in cfg_in["groups"]:
            g = np.load(os.path.join(out, f"group_{arch}_{b}.npz"))
            got = eng.generate({k: torch.from_numpy(g[k]) for k in g.files},
                               cfg_in["steps"])
            arrays[f"{arch}_tokens_{b}"] = got.tokens.numpy()
            arrays[f"{arch}_logits_{b}"] = got.logits_last.numpy()
            r[f"buckets_{b}"] = list(got.buckets)
            r[f"decode_{b}"] = eng.collectives("decode", got.buckets[0])
            prog = next(p for p in eng.programs.programs()
                        if p.kind == "decode" and p.bucket == got.buckets[0])
            r[f"weight_gathers_{b}"] = sum(
                x["op"] == "all-gather" and x["bytes"] in pieces
                for x in prog.comm)
        r["misses"] = registry.stats()["misses"] - misses0
        r["healthy"] = eng.health_report()["healthy"]
        res[arch] = r
        del eng, params
    np.savez(os.path.join(out, f"out_{rank}.npz"), **arrays)
    json.dump(res, open(os.path.join(out, f"res_{rank}.json"), "w"))
    mesh.close()
""")


def seeded(tree, rng):
    """The reference's params with every norm's scale (and a LayerNorm's
    bias) and every GELU MLP's biases drawn away from their init."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        name = path[-1]
        a = np.asarray(node)
        if name.endswith("_s") or name in ("ln1", "ln2", "final_norm"):
            a = 1 + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        elif name.endswith("_b") or name in ("b_in", "b_out"):
            a = 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return jnp.asarray(a)

    return walk(tree, ())


def module_inputs(cfg) -> dict:
    """The module checks' inputs: ``x`` (2, 4, d) for the GELU MLP and the
    LayerNorm, and the cross-attention step's input and cross K/V."""
    rng = np.random.default_rng(41)
    cx, ck, cv = cross_inputs(cfg)
    return {"x": rng.standard_normal((*MODULE_X, cfg.d_model))
            .astype(np.float32), "cx": cx, "ck": ck, "cv": cv}


_REFS: dict = {}


def reference(arch: str) -> tuple:
    """The reference's seeded params, its single-device Engine's groups,
    and for whisper its first decoder layer's ``cross_decode``,
    ``gelu_mlp`` and ``ln1`` on ``module_inputs``."""
    if arch in _REFS:
        return _REFS[arch]
    ref_cfg, cfg = cfg_pair(arch)
    model = ref_build_model(ref_cfg)
    params, axes = model.init(jax.random.PRNGKey(0))
    params = seeded(params, np.random.default_rng(7))
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
        lp = jax.tree.map(lambda a: a[0], params["dec_layers"])
        m = module_inputs(cfg)
        want["module"] = m
        x = jnp.asarray(m["x"])
        want["mod"] = {
            "cross": np.asarray(ref_A.cross_decode(
                lp["cross_attn"], ref_cfg, jnp.asarray(m["cx"]),
                jnp.asarray(m["ck"]), jnp.asarray(m["cv"]))),
            "mlp": np.asarray(ref_L.gelu_mlp(lp["mlp"], x)),
            "ln": np.asarray(ref_L.layernorm(x, lp["ln1_s"], lp["ln1_b"],
                                             ref_cfg.norm_eps))}
    want["flat"] = flat_params(jax.tree.map(np.asarray, params))
    _REFS[arch] = (cfg, want)
    return _REFS[arch]


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


def spawn(tmp_path: Path, layout: str) -> list:
    over = {}
    for arch in ARCHS:
        cfg, want = reference(arch)
        np.savez(tmp_path / f"params_{arch}.npz", **want["flat"])
        for b, _, _ in GROUPS:
            np.savez(tmp_path / f"group_{arch}_{b}.npz", **want[f"group_{b}"])
        if cfg.is_encoder_decoder:
            np.savez(tmp_path / "module.npz", **want["module"])
        over[arch] = dict(WIDE[arch], dtype="float32")
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"archs": ARCHS, "over": over, "buckets": BUCKETS, "groups": GROUPS,
         "steps": STEPS, "max_len": MAX_LEN, "layouts": LAYOUTS,
         "stacks": STACKS}))
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
    (``packed``: the engine's pack report; a leaf missing from it is an
    unpacked piece, LLaVA's reduced ``wk`` / ``wv``), activations of ``e``
    bytes.

    Both layouts: each norm's ``embed`` scale gathered over ``data``, and a
    LayerNorm's bias beside it; where the vocabulary splits (LLaVA's, not
    whisper's odd one) the lookup summed over ``model`` and the logits
    gathered over it; the lookup's columns gathered over ``data``; per
    attention ``wo``'s partials and per MLP ``w_down``'s or ``w_out``'s
    summed over ``model``; where the self-attention slots lie on ``data``
    (bucket 1) its softmax partials gathered over it.

    2D: every rank computes the bucket; each k-split product (``wq`` /
    ``wk`` / ``wv``, the cross-attention's ``wq``, ``w_gate`` / ``w_up``,
    whisper's ``w_in``, the head) summed over ``data``; ``wo``'s,
    ``w_down``'s and ``w_out``'s columns gathered over ``data``; with the
    caches' rows on ``data`` (bucket 2) the self- and cross-attention
    outputs gathered over it.

    FSDP: a data line computes its rows of a bucket it splits (all of
    bucket 1); the ids gathered over ``data`` before the lookup; every
    weight piece gathered over ``data`` before use, ``b_out`` too."""
    d, v, H, hd = cfg.d_model, cfg.vocab_size, cfg.num_heads, cfg.head_dim
    q, kv = H * hd, cfg.num_kv_heads * hd
    two_d = layout == "2d"
    split = bucket % 2 == 0
    rows = bucket if two_d or not split else bucket // 2
    vocab_split = v % 2 == 0
    encdec = cfg.is_encoder_decoder
    ops = []                                   # (op, tensor bytes)

    def ar(b):
        ops.append(("all-reduce", b))

    def ag(b):
        ops.append(("all-gather", b))

    def piece(leaf, k, n):
        """The bytes of a weight gathered over data: its packed blocks',
        or an unpacked row piece's gathered (k, n)."""
        if leaf not in packed:
            return k * n * e
        size = 1
        for s in packed[leaf][-4:]:
            size *= s
        return 2 * size * e

    def product(leaf, k, n):
        """A weight whose rows lie on data (``n`` its columns on the
        rank): 2D a k-split's sum, FSDP its gather."""
        if two_d:
            ar(rows * n * e)
        else:
            ag(piece(leaf, k, n))

    def row_parallel(leaf, k, bias=False):
        """wo, w_down, w_out: rows on model, columns on data."""
        if not two_d:
            ag(piece(leaf, k, d // 2))
            if bias:
                ag(d * e)                                    # b_out
        ar(rows * d // (2 if two_d else 1) * e)
        if two_d:
            ag(rows * d * e)

    def norm():
        ag(d * e)
        if encdec:
            ag(d * e)                                        # the bias

    def attention(stack, name):
        for w, n in (("wq", q), ("wk", kv), ("wv", kv)):
            product(f"{stack}/{name}/{w}", d, n // 2)
        if bucket == 1:
            ag(2 * rows * H // 2 * (hd + 2) * 4)
        elif two_d:
            ag(rows * q // 2 * e)                            # attn output
        row_parallel(f"{stack}/{name}/wo", q // 2)

    if two_d:
        if vocab_split:
            ar(rows * d // 2 * e)
        ag(rows * d * e)
    else:
        ag(2 * rows * 4)
        if vocab_split:
            ar(rows * d * e)
        ag(2 * rows * d * e)
    stack = "dec_layers" if encdec else "layers"
    for _ in range(cfg.num_layers):
        norm()
        attention(stack, "self_attn" if encdec else "attn")
        norm()
        if encdec:
            product(f"{stack}/cross_attn/wq", d, q // 2)
            if two_d and split:
                ag(rows * q // 2 * e)                        # the rows' out
            row_parallel(f"{stack}/cross_attn/wo", q // 2)
            norm()
            product(f"{stack}/mlp/w_in", d, cfg.d_ff // 2)
            row_parallel(f"{stack}/mlp/w_out", cfg.d_ff // 2, bias=True)
        else:
            for w in ("w_gate", "w_up"):
                product(f"{stack}/mlp/{w}", d, cfg.d_ff // 2)
            row_parallel(f"{stack}/mlp/w_down", cfg.d_ff // 2)
    norm()                                                   # final norm
    product("embed/head", d, v // 2 if vocab_split else v)
    if vocab_split:
        ag(rows * v * e)                                     # the logits
    out = {}
    for op, b in ops:
        acc = out.setdefault(op, {"count": 0, "bytes_moved": 0.0,
                                  "tensor_bytes": 0.0})
        acc["count"] += 1
        acc["bytes_moved"] += b * (1.0 if op == "all-reduce" else 0.5)
        acc["tensor_bytes"] += b
    return out


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.abs(got - want) <= F32_TOL + F32_TOL * np.abs(want)), \
        float(np.abs(got - want).max())


@pytest.fixture(scope="module")
def ranks(ref_env, tmp_path_factory):
    return {layout: spawn(tmp_path_factory.mktemp(f"tp2d_vlm_{layout}"),
                          layout) for layout in LAYOUTS}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_vlm_encdec_2d_and_fsdp_engine_matches_the_reference(ranks, layout):
    for arch in ARCHS:
        cfg, want = reference(arch)
        d, n, ff = cfg.d_model, cfg.num_layers, cfg.d_ff
        q = cfg.num_heads * cfg.head_dim
        encdec = cfg.is_encoder_decoder
        stack = "dec_layers" if encdec else "layers"
        for rank, (out, allres) in enumerate(ranks[layout]):
            res = allres[arch]
            assert res["misses"] == 0 and res["healthy"], res
            # only the rank's pieces: every embed dim on data (a norm's
            # scale and bias, b_out), heads and MLP columns on model
            pieces = res["pieces"]
            attn = "self_attn" if encdec else "attn"
            assert pieces[f"{stack}/{attn}/wq"] == [n, d // 2, q // 2]
            assert pieces[f"{stack}/{attn}/wo"] == [n, q // 2, d // 2]
            if encdec:
                assert pieces[f"{stack}/mlp/w_in"] == [n, d // 2, ff // 2]
                assert pieces[f"{stack}/mlp/b_in"] == [n, ff // 2]
                assert pieces[f"{stack}/mlp/w_out"] == [n, ff // 2, d // 2]
                assert pieces[f"{stack}/mlp/b_out"] == [n, d // 2]
                assert pieces[f"{stack}/ln1_s"] == [n, d // 2]
                assert pieces[f"{stack}/ln1_b"] == [n, d // 2]
                assert pieces["enc_layers/ln1_b"] == [
                    cfg.encoder_layers, d // 2]
                assert pieces["enc_norm_b"] == [d // 2]
                # the odd vocabulary whole, the embed dim on data
                assert pieces["embed/tok"] == [cfg.vocab_size, d // 2]
            else:
                assert pieces[f"{stack}/mlp/w_down"] == [n, ff // 2, d // 2]
                assert pieces[f"{stack}/ln1"] == [n, d // 2]
                assert pieces["final_norm"] == [d // 2]
                assert pieces["embed/head"] == [d // 2,
                                                cfg.vocab_size // 2]
            # every packed piece is a shape the install sweep planned
            assert set(map(tuple, res["packed_pieces"])) <= set(
                map(tuple, res["shapes"])), (res["packed_pieces"],
                                             res["shapes"])
            assert "embed/head" in res["packed"]
            # the caches' rows on data at bucket 2; at bucket 1 the
            # self-attention slots on data and the cross cache whole
            for b in BUCKETS:
                c = res["cache"][str(b)]
                rows = b // 2 if b % 2 == 0 else b
                slots = MAX_LEN // 2 if b == 1 else MAX_LEN
                assert c["k"] == [n, rows, slots, cfg.num_kv_heads // 2,
                                  cfg.head_dim], c
                if encdec:
                    assert c["cross_k"] == [n, rows, cfg.encoder_seq,
                                            cfg.num_kv_heads // 2,
                                            cfg.head_dim], c
                lay = res["layouts"][str(b)]
                assert ("rows='data'" in lay) == (b == 2), lay
                assert ("seq='data'" in lay) == (b == 1), lay
                assert ("gathered=True" in lay) == (b == 2 and layout == "2d")
            for b, _, _ in GROUPS:
                np.testing.assert_array_equal(out[f"{arch}_tokens_{b}"],
                                              want[f"tokens_{b}"])
                _close(out[f"{arch}_logits_{b}"], want[f"logits_{b}"])
                bucket = res[f"buckets_{b}"][0]
                assert res[f"decode_{b}"] == decode_contract(
                    cfg, layout, bucket, res["packed"]), (arch, b)


@pytest.mark.parametrize("module", ["cross", "mlp", "ln"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_whisper_modules_on_the_rank_pieces(ranks, layout, module):
    """whisper's first decoder layer's modules on each rank's pieces
    against the reference's whole modules: ``cross_decode`` with the cross
    cache's rows on ``data`` (and its heads on ``model``), ``gelu_mlp``
    with ``w_in``'s rows on ``data`` (2D: a k-split, the bias and GELU
    after the sum) and ``w_out``'s columns with the matching ``b_out``
    piece, ``layernorm`` from its scale and bias pieces.  The output whole
    (2D: every rank computes the bucket) or the data line's row (FSDP)."""
    cfg, want = reference("whisper_base")
    ref = want["mod"][module]
    for rank, (out, _) in enumerate(ranks[layout]):
        i = rank // 2
        got = out[f"whisper_base_mod_{module}"]
        _close(got, ref if layout == "2d" else ref[i:i + 1])


def test_vlm_encdec_2d_decode_gathers_no_weight(ranks):
    """A 2D decode call gathers no weight piece (FSDP's gathers every
    one: the control of the count), and moves fewer bytes than FSDP's at
    every bucket."""
    for arch in ARCHS:
        for (_, two), (_, fsdp) in zip(ranks["2d"], ranks["fsdp"]):
            for b, _, _ in GROUPS:
                assert two[arch][f"weight_gathers_{b}"] == 0
                assert fsdp[arch][f"weight_gathers_{b}"] > 0
                assert 0 < bytes_moved(two[arch][f"decode_{b}"]) < \
                    bytes_moved(fsdp[arch][f"decode_{b}"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_shapes_of_the_vlm_and_encdec_families(arch):
    """The LLaVA-NeXT backbone's and whisper-base's per-rank problems at
    their published widths on ``data=2,model=2``: every projection's
    (K/2, N/2) piece at each bucket under 2D and its gathered K at the data
    line's rows under FSDP (whisper's tied head over its odd vocabulary
    whole, its rows alone on ``data``); and the rows a rank's prefill runs
    (``rank_prefill_rows``): the whole bucket's image embeddings and
    tokens, or frames, under 2D, the data line's under FSDP."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.install import (parse_mesh, rank_prefill_rows,
                                          sharded_serving_shapes)
    from repro_torch.sharding.rules import ShardingOptions
    cfg = get_config(arch)
    mesh = parse_mesh("data=2,model=2")
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    buckets, lengths = (1, 2), (256,)
    two = ShardingOptions(fsdp=True, serve_2d_tp=True)
    fsdp = ShardingOptions(fsdp=True)
    tp2d = sharded_serving_shapes(cfg, mesh, two, buckets=buckets,
                                  lengths=lengths)
    line = sharded_serving_shapes(cfg, mesh, fsdp, buckets=buckets,
                                  lengths=lengths)
    rows = {(d, q), (d, kv), (d, ff)}                # rows on data
    cols = {(q, d), (ff, d)}                         # columns on data
    for b in buckets:
        assert {(b, k // 2, n // 2, 4) for k, n in rows | cols} <= tp2d
    assert {(1, k, n // 2, 2) for k, n in rows} <= line
    assert {(1, k // 2, n, 2) for k, n in cols} <= line
    if cfg.is_encoder_decoder:
        # the tied head: the odd vocabulary whole
        assert {(b, d // 2, v, 2) for b in buckets} <= tp2d
        assert (1, d, v, 1) in line
        extra = cfg.encoder_seq
    else:
        assert {(b, d // 2, v // 2, 4) for b in buckets} <= tp2d
        assert (1, d, v // 2, 2) in line
        extra = cfg.num_image_tokens + lengths[0]
    assert {b * extra for b in buckets} <= set(
        rank_prefill_rows(cfg, buckets, lengths, mesh, two))
    assert extra in rank_prefill_rows(cfg, buckets, lengths, mesh, fsdp)
    assert 2 * extra not in rank_prefill_rows(cfg, buckets, lengths, mesh,
                                              fsdp)
