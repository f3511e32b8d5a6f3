"""The parts of 2D tensor-parallel and FSDP serving, one at a time.

* The k-split packed product (``core/tsmm.py::tsmm_dot`` on a rank's row
  piece under ``serve_2d_tp``) with a bias and SiLU equals the unsplit
  product, and applying the epilogue before the data group's sum does
  not; FSDP's gathered product equals it too (2 gloo ranks, fp32).
* The split-softmax combine (``models/attention.py``) over 2 and 4
  pieces equals ``decode_attention`` over the whole cache, with a piece
  holding no valid slot (its share exactly zero, no NaN), per-row
  ``valid_from`` and a sliding window.
* ``core/install.py::sharded_serving_shapes`` keys each mode's
  per-rank problems: (bucket, K/2, N/2) under 2D tensor parallelism,
  (bucket/2, K, N/2) under FSDP.
* ``sharding/context.py::check_dense_mesh`` still refuses sequence
  parallelism, every family but the dense one in training, and 2D
  tensor parallelism outside serving; it serves every family (the MoE,
  SSM, hybrid, VLM and encoder-decoder ones among them) under FSDP and
  2D tensor parallelism.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core.install import sharded_serving_shapes
from repro_torch.models.attention import (combine_partials, decode_attention,
                                          decode_partial)
from repro_torch.sharding.context import check_dense_mesh
from repro_torch.sharding.rules import Mesh, ShardingOptions

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 120

WORKER = textwrap.dedent("""
    import json, os, sys
    import torch
    from repro_torch.core.linear import serving_ctx
    from repro_torch.core.packing import pack
    from repro_torch.core.tsmm import tsmm_dot
    from repro_torch.kernels.ref import act_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import comm
    from repro_torch.sharding.context import sharding_ctx
    from repro_torch.sharding.rules import ShardingOptions

    rank, out = int(sys.argv[1]), sys.argv[2]
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu", rank=rank,
                     world_size=2, init_file=os.path.join(out, "store"),
                     verbose=False)
    g = torch.Generator().manual_seed(3)
    m, k, n = 4, 1024, 768
    w = torch.randn((k, n), generator=g) / k ** 0.5
    x = torch.randn((m, k), generator=g)
    bias = torch.randn((n,), generator=g)
    want = tsmm_dot(x, pack(w, 128, 128), bias=bias, act="silu")
    half = k // 2
    piece = w[rank * half:(rank + 1) * half].contiguous()
    res = {}
    for name, opts in (("tp2d", ShardingOptions(fsdp=True,
                                                serve_2d_tp=True)),
                       ("fsdp", ShardingOptions(fsdp=True))):
        pk = pack(piece, 128, 128)
        pk.spec = ("data", "model")
        with serving_ctx(), sharding_ctx(mesh, opts), \\
                comm.recording() as rec:
            got = tsmm_dot(x, pk, bias=bias, act="silu")
        res[name] = {"err": float((got - want).abs().max()),
                     "ops": [(r["op"], r["bytes"]) for r in rec]}
    # the epilogue on each partial product, then the sum: SiLU of the
    # partial sums, the bias added once per data rank
    part = act_ref(x[:, rank * half:(rank + 1) * half] @ piece + bias,
                   "silu")
    early = comm.all_reduce(part.contiguous(), mesh.group("data"))
    res["early_err"] = float((early - want).abs().max())
    res["want_absmax"] = float(want.abs().max())
    json.dump(res, open(os.path.join(out, f"res_{rank}.json"), "w"))
    mesh.close()
""")


def test_ksplit_applies_the_epilogue_once_after_the_sum(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
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
    for r in range(2):
        res = json.loads((tmp_path / f"res_{r}.json").read_text())
        assert res["tp2d"]["err"] <= 1e-5 and res["fsdp"]["err"] <= 1e-5
        # 2D: one all-reduce of the (4, 768) fp32 partial; FSDP: one
        # all-gather of the (1024, 768) packed weight
        assert res["tp2d"]["ops"] == [["all-reduce", 4 * 768 * 4]]
        assert res["fsdp"]["ops"] == [["all-gather", 1024 * 768 * 4]]
        assert res["early_err"] > 0.1 * res["want_absmax"]


def _whole_and_pieces(n_pieces: int, *, window: int = 0, cur: int = 12,
                      seed: int = 0):
    """A (B=3, S=32) cache with GQA (4 q heads over 2 kv heads), filled
    up to ``cur``, split into ``n_pieces`` along the slots (the last holds
    only empty slots): the whole cache's ``decode_attention`` and the
    pieces' combine."""
    g = torch.Generator().manual_seed(seed)
    b, s, h, kh, d = 3, 32, 4, 2, 16
    q = torch.randn((b, 1, h, d), generator=g)
    kc = torch.randn((b, s, kh, d), generator=g)
    vc = torch.randn((b, s, kh, d), generator=g)
    pos = torch.arange(s, dtype=torch.int32)
    k_pos = torch.where(pos <= cur, pos, -1)
    valid_from = torch.tensor([0, 3, 9], dtype=torch.int32)
    cur_pos = torch.tensor(cur, dtype=torch.int32)
    whole = decode_attention(q, kc, vc, k_pos, cur_pos, window=window,
                             valid_from=valid_from)
    n = s // n_pieces
    parts = [decode_partial(q, kc[:, i * n:(i + 1) * n],
                            vc[:, i * n:(i + 1) * n],
                            k_pos[i * n:(i + 1) * n], cur_pos,
                            window=window, valid_from=valid_from)
             for i in range(n_pieces)]
    m, l, acc = (torch.stack(t) for t in zip(*parts))
    got = combine_partials(m, l, acc).reshape(b, 1, h, d)
    return whole, got, m, l, acc


@pytest.mark.parametrize("n_pieces", [2, 4])
@pytest.mark.parametrize("window", [0, 6])
def test_split_softmax_combine_equals_the_whole_cache(n_pieces, window):
    whole, got, m, l, acc = _whole_and_pieces(n_pieces, window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-6)
    # the last piece holds only empty slots (positions past 12): its max
    # is -inf and its sums exactly zero
    assert torch.isneginf(m[-1]).all()
    assert (l[-1] == 0).all() and (acc[-1] == 0).all()


def test_a_piece_with_no_valid_slot_weighs_zero():
    """A piece whose slots are all masked (its m = -inf) next to one whose
    scores are finite: the combine reads only the finite one, and a
    combine of only empty pieces gives zeros, never NaN."""
    g = torch.Generator().manual_seed(1)
    m = torch.tensor([[1.5], [float("-inf")]])
    l = torch.tensor([[2.0], [0.0]])
    acc = torch.randn((2, 1, 4), generator=g)
    acc[1] = 0
    out = combine_partials(m, l, acc)
    torch.testing.assert_close(out, acc[0] / 2.0)
    empty = combine_partials(torch.full((2, 1), float("-inf")),
                             torch.zeros((2, 1)), torch.zeros((2, 1, 4)))
    assert torch.equal(empty, torch.zeros((1, 4)))


def test_sharded_serving_shapes_follow_the_mode():
    cfg = get_config("qwen1_5_4b")
    mesh = Mesh.of((2, 2), ("data", "model"))
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    buckets = (1, 2, 4)
    tp2d = sharded_serving_shapes(cfg, mesh, ShardingOptions(
        fsdp=True, serve_2d_tp=True), buckets=buckets)
    fsdp = sharded_serving_shapes(cfg, mesh, ShardingOptions(fsdp=True),
                                  buckets=buckets)
    for b in buckets:
        # wq (d, d): rows on data, columns on model
        assert (b, d // 2, d // 2, 4) in tp2d
        assert (b, d // 2, ff // 2, 4) in tp2d           # w_gate / w_up
        assert (b, ff // 2, d // 2, 4) in tp2d           # w_down
        assert (b, d // 2, v // 2, 4) in tp2d            # the head
    # FSDP: the rows each data line computes (a bucket of 1 stays whole),
    # on the gathered weight
    assert {m for (m, _, _, _) in fsdp} == {1, 2}
    for m in (1, 2):
        assert (m, d, d // 2, 2) in fsdp                 # wq gathered
        assert (m, ff // 2, d, 2) in fsdp                # w_down gathered
        assert (m, d, v // 2, 2) in fsdp                 # the head
    assert all(s == 4 for (_, _, _, s) in tp2d)
    assert all(s == 2 for (_, _, _, s) in fsdp)
    # without buckets: the pieces, as before
    assert (d // 2, d // 2, 4) in sharded_serving_shapes(
        cfg, mesh, ShardingOptions(fsdp=True))


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_2_7b"])
def test_sharded_serving_shapes_of_the_ssm_family(arch):
    """Mamba2-780m's and Zamba2-2.7B's per-rank problems at their published
    widths on ``data=2,model=2``: the segmented ``w_in`` piece (its heads'
    ``z`` / ``x`` / ``dt`` and the whole ``B`` / ``C``) over K / 2 rows
    under 2D and the gathered K under FSDP; ``w_out``'s rows on ``model``
    and columns on ``data``; the head (Mamba2's tied one), and the
    hybrid's shared block over its 2 d_model rows."""
    cfg = get_config(arch)
    mesh = Mesh.of((2, 2), ("data", "model"))
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    seg = di + 2 * cfg.ssm_groups * cfg.ssm_state + h // 2
    v = cfg.vocab_size
    buckets = (1, 2, 4)
    tp2d = sharded_serving_shapes(cfg, mesh, ShardingOptions(
        fsdp=True, serve_2d_tp=True), buckets=buckets)
    fsdp = sharded_serving_shapes(cfg, mesh, ShardingOptions(fsdp=True),
                                  buckets=buckets)
    for b in buckets:
        assert (b, d // 2, seg, 4) in tp2d               # w_in
        assert (b, di // 2, d // 2, 4) in tp2d           # w_out
        assert (b, d // 2, v // 2, 4) in tp2d            # the head
    for m in (1, 2):
        assert (m, d, seg, 2) in fsdp                    # w_in gathered
        assert (m, di // 2, d, 2) in fsdp                # w_out gathered
        assert (m, d, v // 2, 2) in fsdp
    if cfg.family == "hybrid":
        q, ff = cfg.num_heads * cfg.head_dim, cfg.d_ff
        for b in buckets:
            assert (b, d, q // 2, 4) in tp2d             # [x, x0] rows
            assert (b, d, ff // 2, 4) in tp2d
            assert (b, ff // 2, d // 2, 4) in tp2d
        assert (2, 2 * d, q // 2, 2) in fsdp
    assert all(s == 4 for (_, _, _, s) in tp2d)
    assert all(s == 2 for (_, _, _, s) in fsdp)


class _FakeMesh:
    """A process mesh's surface for ``check_dense_mesh``."""
    shape = {"data": 2, "model": 2}
    backend = "gloo"
    device = torch.device("cpu")

    def group(self, axis):
        return None


@pytest.mark.parametrize("opts,serving,arch", [
    (ShardingOptions(fsdp=True, serve_2d_tp=True,
                     sequence_parallel="model"), True, "qwen1_5_4b"),
    (ShardingOptions(fsdp=True, sequence_parallel=True), True, "qwen1_5_4b"),
    (ShardingOptions(fsdp=True, serve_2d_tp=True), False, "qwen1_5_4b"),
    (ShardingOptions(fsdp=True, serve_2d_tp=True), True, "olmoe_1b_7b"),
    (ShardingOptions(fsdp=True), True, "mamba2_780m"),
    (ShardingOptions(), False, "mamba2_780m"),
    (ShardingOptions(), False, "zamba2_2_7b"),
    (ShardingOptions(fsdp=True, serve_2d_tp=True), True,
     "llava_next_mistral_7b"),
    (ShardingOptions(), False, "whisper_base"),
    (ShardingOptions(fsdp=True), True, "olmoe_1b_7b"),
    (ShardingOptions(fsdp=True, serve_2d_tp=True), True, "deepseek_v2_236b"),
    (ShardingOptions(sequence_parallel="model"), True, "olmoe_1b_7b"),
    (ShardingOptions(), False, "olmoe_1b_7b"),
    (ShardingOptions(fsdp=True, serve_2d_tp=True), True, "zamba2_2_7b"),
    (ShardingOptions(fsdp=True), True, "llava_next_mistral_7b"),
    (ShardingOptions(fsdp=True, serve_2d_tp=True), True, "whisper_base"),
    (ShardingOptions(fsdp=True), True, "whisper_base"),
    (ShardingOptions(fsdp=True), False, "llava_next_mistral_7b"),
    (ShardingOptions(fsdp=True, sequence_parallel=True), True,
     "whisper_base"),
])
def test_check_dense_mesh_refusals(opts, serving, arch):
    """Each case refused, but a non-dense family's serving under FSDP or
    2D tensor parallelism without sequence parallelism: served since it
    runs there (tests/test_torch_tp2d_moe.py, tests/test_torch_tp2d_ssm.py,
    tests/test_torch_tp2d_vlm_encdec.py), and the MoE family's training
    without 2D or sequence parallelism (tests/test_torch_dist_train_moe.py),
    each returning the head split (the Mamba2 heads' among it)."""
    cfg = get_reduced_config(arch)
    trained = (cfg.family == "moe" and not serving
               and not opts.serve_2d_tp and not opts.sequence_parallel)
    if (cfg.family != "dense" and serving and not opts.sequence_parallel
            or trained):
        wide = cfg.reduced(d_model=512, num_heads=4 if cfg.num_heads else 0,
                           num_kv_heads=4 if cfg.num_heads else 0,
                           head_dim=128)
        split = check_dense_mesh(wide, _FakeMesh(), opts, "serving",
                                 serving=serving)
        assert split["qheads"] == bool(cfg.num_heads)
        assert split.get("kvheads", False) == bool(
            cfg.num_heads and not cfg.use_mla)
        assert split.get("ssm_heads", False) == bool(cfg.ssm_state)
        return
    with pytest.raises(NotImplementedError):
        check_dense_mesh(cfg, _FakeMesh(), opts, "serving", serving=serving)


def test_check_dense_mesh_serves_2d_and_fsdp():
    cfg = get_reduced_config("qwen1_5_4b").reduced(
        d_model=512, d_ff=1024, num_heads=4, num_kv_heads=4, head_dim=128)
    for opts in (ShardingOptions(fsdp=True, serve_2d_tp=True),
                 ShardingOptions(fsdp=True)):
        split = check_dense_mesh(cfg, _FakeMesh(), opts, "serving",
                                 serving=True)
        assert split == {"qheads": True, "kvheads": True}
