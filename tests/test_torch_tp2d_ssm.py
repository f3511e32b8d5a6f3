"""The SSM family and the hybrid under 2D weight-stationary tensor
parallelism and FSDP serving (gloo, CPU) against the reference's
single-device Engine.

Reduced Mamba2-780m and Zamba2-2.7B, widened as in ``test_torch_tp_ssm.py``
so that ``w_in``, ``w_out``, the tied head and the shared block's
projections pack, fp32.  For each layout one spawn of four ranks over a
file store, ``data=2,model=2``, serves both archs on
``Engine(mesh=, opts=)`` from their pieces (``params_from_numpy``'s
sharded form) after ``install_arch(mesh=, opts=)``:

* ``ShardingOptions(fsdp=True, serve_2d_tp=True)`` (2D): every rank
  computes the whole bucket over pieces that never move: ``w_in`` (rows
  on ``data``, columns on ``model`` by segments), the tied head and the
  shared block's ``[x, x0]`` projections contracted over the rank's K
  slice and summed over ``data``; ``w_out``'s, ``wo``'s and ``w_down``'s
  columns gathered over it; at bucket 2 the recurrent state's and the
  conv window's rows on ``data`` (each rank's conv, state update and
  readout on its rows, the per-row output gathered), at bucket 1 the
  state whole and the hybrid's K/V slots on ``data``;
* ``ShardingOptions(fsdp=True)`` (FSDP): each piece gathered over
  ``data`` before use, each data line computing its rows.

Checks: tokens equal and logits within ``F32_TOL`` (1e-4 + 1e-4 |ref|) at
buckets 1 and 2, 0 registry misses, only the rank's pieces held, one
decode call's collectives equal to the contract from the shapes, no
weight gathered in a 2D decode call and 2D moving fewer bytes than FSDP;
the segmented cut with rows on ``data`` (each rank's ``w_in`` / conv
pieces equal to the reference's slices), and the Mamba2 block on the
rank's pieces against the reference's whole block under each layout's
cell layout.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.core import registry as ref_registry
from repro_torch.analysis.collectives import bytes_moved
from test_torch_tp_ssm import (ARCHS, BUCKETS, F32_TOL, GROUPS, MAX_LEN,
                               MODULE_X, STEPS, WIDE, module_x, reference,
                               segments)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300
LAYOUTS = {"2d": dict(fsdp=True, serve_2d_tp=True), "fsdp": dict(fsdp=True)}


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
    from repro_torch.models import mamba2 as M
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
        misses0 = registry.stats()["misses"]
        model = build_model(cfg)
        axes = model.init(MetaGenerator())[1]
        params = params_from_numpy(tree_of(os.path.join(
            out, f"params_{arch}.npz")), "cpu", mesh=mesh, axes=axes,
            opts=opts, cfg=cfg)
        stack = params["layers" if cfg.family == "ssm" else "mamba_layers"]
        p0 = layer_params(stack, 0)["mamba"]
        for name in ("w_in", "conv_w", "conv_b", "w_out"):
            arrays[f"{arch}_{name}"] = p0[name].numpy()
        r = {"pieces": {"/".join(k): list(v.shape) for k, v in leaves(params)
                        if k[-1] in ("w_in", "w_out", "tok", "wq", "ln1",
                                     "w_down", "norm")}}
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
        # 2 x the bytes a layer of every weight piece of two dims or more
        # (packed blocks or unpacked), the size of its gather over data
        pieces = set()

        def walk(t, lead):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, lead or k in ("layers", "mamba_layers"))
                return
            t = getattr(t, "blocks", t)
            if t.ndim - lead >= 2:
                n = t.numel() // (t.shape[0] if lead else 1)
                pieces.add(2 * n * t.element_size())

        walk(eng.params, False)
        for b, plen, seed in cfg_in["groups"]:
            toks = np.load(os.path.join(out, f"toks_{arch}_{b}.npy"))
            got = eng.generate({"tokens": torch.from_numpy(toks)},
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
        del eng
        # the Mamba2 block on the rank's pieces in a cell whose state rows
        # lie on data: 2D computes the whole bucket (its rows' state), FSDP
        # a data line's rows
        x, x2 = (torch.from_numpy(a) for a in np.load(
            os.path.join(out, "module_x.npz")).values())
        i = mesh.coords["data"]
        if opts.serve_2d_tp:
            lay = CacheLayout(rows="data", gathered=True)
        else:
            lay = CacheLayout(rows="data")
            x, x2 = x[i:i + 1], x2[i:i + 1]
        with torch.inference_mode(), serving_ctx(), \\
                sharding_ctx(mesh, opts, layout=lay):
            y, (h, tail) = M.mamba2_forward(p0, cfg, x)
            yd, ssm, conv = M.mamba2_decode(p0, cfg, x2, h, tail)
        for k, v in (("y", y), ("h", h), ("tail", tail), ("yd", yd),
                     ("ssm", ssm), ("conv", conv)):
            arrays[f"{arch}_mod_{k}"] = v.numpy()
        res[arch] = r
        del params
    np.savez(os.path.join(out, f"out_{rank}.npz"), **arrays)
    json.dump(res, open(os.path.join(out, f"res_{rank}.json"), "w"))
    mesh.close()
""")


@pytest.fixture(scope="module")
def ref_env(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PLAN_CACHE",
              str(tmp_path_factory.mktemp("ref_plans") / "plans.json"))
    ref_registry.clear_memory()
    yield
    mp.undo()
    ref_registry.clear_memory()


def spawn(tmp_path: Path, layout: str) -> list:
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
         "steps": STEPS, "max_len": MAX_LEN, "layouts": LAYOUTS}))
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
    the gated norm's sums of squares in fp32.

    Both layouts: each norm's ``embed`` scale gathered over ``data`` (the
    shared block's 2 d_model wide); the lookup summed over ``model`` and
    its columns gathered over ``data``; per Mamba2 layer the gated norm's
    (rows, 1) sums and ``w_out``'s partials summed over ``model``; per
    application of the shared block ``wo``'s and ``w_down``'s partials
    summed over ``model``, and where its K/V slots lie on ``data`` (bucket
    1) its softmax partials gathered over it; the logits gathered over
    ``model``.

    2D: every rank computes the bucket; each k-split product (``w_in``,
    the shared ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up``, the head)
    summed over ``data``; ``w_out``'s, ``wo``'s and ``w_down``'s columns
    gathered over ``data``; with the state's rows on ``data`` (bucket 2)
    each Mamba2 layer's per-row ``y`` gathered over it, and the shared
    block's attention output too.

    FSDP: a data line computes its rows of a bucket it splits (all of
    bucket 1); the ids gathered over ``data`` before the lookup; every
    packed piece gathered over ``data`` before use."""
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

    def packed_product(leaf, n_out):
        """A packed piece with rows on data: 2D a k-split sum, FSDP its
        gather."""
        if two_d:
            ar(rows * n_out * e)
        else:
            ag(blocks(leaf))

    def row_parallel(leaf):
        """w_out, wo, w_down: rows on model, columns on data."""
        if not two_d:
            ag(blocks(leaf))
        ar(rows * d // (2 if two_d else 1) * e)
        if two_d:
            ag(rows * d * e)

    if two_d:
        ar(rows * d // 2 * e)
        ag(rows * d * e)
    else:
        ag(2 * rows * 4)
        ar(rows * d * e)
        ag(2 * rows * d * e)
    di, h = cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    stack = "layers" if cfg.family == "ssm" else "mamba_layers"
    for i in range(cfg.num_layers):
        ag(d * e)                                            # ln1
        packed_product(f"{stack}/mamba/w_in", di + 2 * gn + h // 2)
        if two_d and split:
            ag(rows * di // 2 * e)                           # the rows' y
        ar(rows * 4)                                         # gated norm
        row_parallel(f"{stack}/mamba/w_out")
        if cfg.family != "hybrid" or (i + 1) % cfg.attn_every:
            continue
        q = H * cfg.head_dim
        ag(2 * d * e)                                        # shared ln1
        for w in ("wq", "wk", "wv"):
            packed_product(f"shared/attn/{w}", q // 2)
        if bucket == 1:
            ag(2 * rows * H // 2 * (cfg.head_dim + 2) * 4)
        elif two_d:
            ag(rows * q // 2 * e)                            # attn output
        row_parallel("shared/attn/wo")
        ag(2 * d * e)                                        # shared ln2
        for w in ("w_gate", "w_up"):
            packed_product(f"shared/mlp/{w}", cfg.d_ff // 2)
        row_parallel("shared/mlp/w_down")
    ag(d * e)                                                # final norm
    packed_product("embed/head", v // 2)
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
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.abs(got - want) <= F32_TOL + F32_TOL * np.abs(want)), \
        float(np.abs(got - want).max())


@pytest.fixture(scope="module")
def ranks(ref_env, tmp_path_factory):
    return {layout: spawn(tmp_path_factory.mktemp(f"tp2d_ssm_{layout}"),
                          layout) for layout in LAYOUTS}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ssm_2d_and_fsdp_engine_matches_the_reference(ranks, layout):
    for arch in ARCHS:
        cfg, want = reference(arch)
        d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
        gn = cfg.ssm_groups * cfg.ssm_state
        stack = "layers" if cfg.family == "ssm" else "mamba_layers"
        n = cfg.num_layers
        for rank, (out, allres) in enumerate(ranks[layout]):
            res = allres[arch]
            assert res["misses"] == 0 and res["healthy"], res
            # only the rank's pieces: w_in's rows on data and its segments
            # on model, w_out's rows on model and columns on data, the
            # gated norm's channels on model alone, the token table's
            # vocabulary and embed dim, the shared block's 2 d rows
            pieces = res["pieces"]
            assert pieces[f"{stack}/mamba/w_in"] == [
                n, d // 2, di + 2 * gn + h // 2]
            assert pieces[f"{stack}/mamba/w_out"] == [n, di // 2, d // 2]
            assert pieces[f"{stack}/mamba/norm"] == [n, di // 2]
            assert pieces[f"{stack}/ln1"] == [n, d // 2]
            assert pieces["embed/tok"] == [cfg.vocab_size // 2, d // 2]
            if cfg.family == "hybrid":
                q = cfg.num_heads * cfg.head_dim
                assert pieces["shared/attn/wq"] == [d, q // 2]
                assert pieces["shared/ln1"] == [d]
                assert pieces["shared/mlp/w_down"] == [cfg.d_ff // 2, d // 2]
            # every packed piece is a shape the install sweep planned, the
            # tied head among them
            assert set(map(tuple, res["packed_pieces"])) <= set(
                map(tuple, res["shapes"])), (res["packed_pieces"],
                                             res["shapes"])
            for leaf in (f"{stack}/mamba/w_in", f"{stack}/mamba/w_out",
                         "embed/head"):
                assert leaf in res["packed"], (leaf, res["packed"])
            # the state's and the conv window's rows on data at bucket 2
            for b in BUCKETS:
                c = res["cache"][str(b)]
                rows = b // 2 if b % 2 == 0 else b
                assert c["ssm"][-4:] == [rows, h // 2, cfg.ssm_head_dim,
                                         cfg.ssm_state], c
                assert c["conv"][-3:] == [rows, cfg.ssm_conv - 1,
                                          di // 2 + 2 * gn], c
                lay = res["layouts"][str(b)]
                assert ("rows='data'" in lay) == (b == 2), lay
                assert ("gathered=True" in lay) == (b == 2 and layout == "2d")
                if cfg.family == "hybrid":
                    assert c["k"][1] == rows
                    assert ("seq='data'" in lay) == (b == 1), lay
            for b, _, _ in GROUPS:
                np.testing.assert_array_equal(out[f"{arch}_tokens_{b}"],
                                              want[f"tokens_{b}"])
                _close(out[f"{arch}_logits_{b}"], want[f"logits_{b}"])
                bucket = res[f"buckets_{b}"][0]
                assert res[f"decode_{b}"] == decode_contract(
                    cfg, layout, bucket, res["packed"]), (arch, b)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ssm_segmented_cut_with_rows_on_data(ranks, layout):
    """Each rank's ``w_in`` / conv pieces at ``(data, model)``: the
    reference's rows of the data coordinate (``w_in``'s ``embed`` dim,
    ``w_out``'s columns) and columns of the model coordinate's heads by
    segments; and the Mamba2 block on those pieces in a cell whose state
    rows lie on ``data``, against the reference's whole block: the output
    whole (2D) or the data line's rows (FSDP), the states the rank's rows
    and heads."""
    for arch in ARCHS:
        cfg, want = reference(arch)
        d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
        gn = cfg.ssm_groups * cfg.ssm_state
        p0, mod = want["p0"], want["mod"]
        for rank, (out, _) in enumerate(ranks[layout]):
            i, j = divmod(rank, 2)
            half = slice(i * d // 2, (i + 1) * d // 2)
            np.testing.assert_array_equal(
                out[f"{arch}_w_in"],
                p0["w_in"][half][:, segments(cfg, j, p0["w_in"].shape[-1])])
            np.testing.assert_array_equal(
                out[f"{arch}_w_out"],
                p0["w_out"][j * di // 2:(j + 1) * di // 2, half])
            conv_cols = segments(cfg, j, di + 2 * gn)
            for name in ("conv_w", "conv_b"):
                np.testing.assert_array_equal(out[f"{arch}_{name}"],
                                              p0[name][..., conv_cols])
            heads = slice(j * h // 2, (j + 1) * h // 2)
            rows = slice(i, i + 1)
            if layout == "2d":
                _close(out[f"{arch}_mod_y"], mod["y"])
                _close(out[f"{arch}_mod_yd"], mod["yd"])
            else:
                _close(out[f"{arch}_mod_y"], mod["y"][rows])
                _close(out[f"{arch}_mod_yd"], mod["yd"][rows])
            assert out[f"{arch}_mod_h"].shape[0] == MODULE_X[0] // 2
            _close(out[f"{arch}_mod_h"], mod["h"][rows, heads])
            _close(out[f"{arch}_mod_ssm"], mod["ssm"][rows, heads])
            _close(out[f"{arch}_mod_tail"], mod["tail"][rows][..., conv_cols])
            _close(out[f"{arch}_mod_conv"], mod["conv"][rows][..., conv_cols])


def test_ssm_2d_decode_gathers_no_weight(ranks):
    """A 2D decode call gathers no weight piece (FSDP's gathers every
    packed piece: the control of the count), and moves fewer bytes than
    FSDP's at every bucket."""
    for arch in ARCHS:
        for (_, two), (_, fsdp) in zip(ranks["2d"], ranks["fsdp"]):
            for b, _, _ in GROUPS:
                assert two[arch][f"weight_gathers_{b}"] == 0
                assert fsdp[arch][f"weight_gathers_{b}"] > 0
                assert 0 < bytes_moved(two[arch][f"decode_{b}"]) < \
                    bytes_moved(fsdp[arch][f"decode_{b}"])
