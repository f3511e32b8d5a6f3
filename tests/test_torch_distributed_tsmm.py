"""The distributed TSMM of the port on ``torch.distributed`` (gloo, CPU)
against the reference's ``kernels/ref.py::tsmm_ref``.

Ranks are fresh interpreters spawned over a file store in ``tmp_path``
(``launch/mesh.py::make_mesh``), every case of one world size in one
spawn.  Each rank reads the same seeded numpy inputs, runs
``distributed_tsmm`` (tall dim split, B replicated: natural and
pre-packed A), ``conventional_ksplit`` (K split, one all-reduce) and
``overlapped_ring_tsmm`` (K split, a ring of isend / irecv), and writes
its outputs and the collective record of each call.  The parent holds
the outputs to ``tsmm_ref`` within 1e-4 + 1e-4 |ref| (fp32, K = 1024
terms) and the counts to 0 / 1 all-reduce / 2 (n - 1) ring sends; and
``comm.broadcast`` from the last rank to every rank.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.ref import tsmm_ref

REPO = Path(__file__).resolve().parents[1]
M, K, N = 1024, 1024, (8, 96)
TOL = 1e-4
TIMEOUT = 120

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    from repro_torch.core.packing import pack
    from repro_torch.core.plan import Problem
    from repro_torch.core.autotuner import make_plan
    from repro_torch.core.tsmm import (conventional_ksplit, distributed_tsmm,
                                       overlapped_ring_tsmm)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import comm

    rank, world = int(sys.argv[1]), int(sys.argv[2])
    out_dir = sys.argv[3]
    M, K, NS = {M}, {K}, {NS}
    mesh = make_mesh((world,), ("data",), device="cpu", rank=rank,
                     world_size=world,
                     init_file=os.path.join(out_dir, "store"), verbose=False)
    g = mesh.group("data")
    res, counts = {{}}, {{}}

    def run(name, fn):
        with comm.recording() as rec:
            res[name] = fn().numpy()
        counts[name] = [dict(r) for r in rec]

    for n in NS:
        rng = np.random.default_rng(n)
        a = rng.standard_normal((M, K)).astype(np.float32)
        b = rng.standard_normal((K, n)).astype(np.float32)
        rows = slice(rank * M // world, (rank + 1) * M // world)
        cols = slice(rank * K // world, (rank + 1) * K // world)
        a_rows = torch.from_numpy(a[rows].copy())
        bt = torch.from_numpy(b)
        plan = make_plan(Problem(M // world, K, n, "float32", world),
                         device="cpu")
        run(f"tall_{{n}}", lambda: distributed_tsmm(a_rows, bt, g))
        ap = pack(a_rows, plan.bm, plan.bk)
        run(f"tall_packed_{{n}}",
            lambda: distributed_tsmm(ap, bt, g, plan=plan))
        a_cols = torch.from_numpy(a[:, cols].copy())
        b_rows = torch.from_numpy(b[cols].copy())
        run(f"ksplit_{{n}}", lambda: conventional_ksplit(a_cols, b_rows, g))
        run(f"ring_{{n}}", lambda: overlapped_ring_tsmm(a_cols, b_rows, g))
    run("broadcast", lambda: comm.broadcast(
        torch.full((3,), float(rank + 1)), world - 1, g))
    np.savez(os.path.join(out_dir, f"out_{{rank}}.npz"), **res)
    with open(os.path.join(out_dir, f"counts_{{rank}}.json"), "w") as f:
        json.dump({{"counts": counts, "backend": mesh.backend}}, f)
    mesh.close()
""").format(M=M, K=K, NS=N)


def spawn(world: int, tmp_path: Path) -> list:
    """Run the worker on ``world`` ranks; returns each rank's (outputs,
    record)."""
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
            [sys.executable, str(script), str(r), str(world), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
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
             json.loads((tmp_path / f"counts_{r}.json").read_text()))
            for r in range(world)]


def ops_of(record: list) -> list:
    return [r["op"] for r in record]


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_tsmm_ksplit_and_ring(world, tmp_path):
    ranks = spawn(world, tmp_path)
    for n in N:
        rng = np.random.default_rng(n)
        a = rng.standard_normal((M, K)).astype(np.float32)
        b = rng.standard_normal((K, n)).astype(np.float32)
        want = np.asarray(tsmm_ref(jnp.asarray(a), jnp.asarray(b)))
        bound = TOL + TOL * np.abs(want)
        rows = M // world
        for r, (out, meta) in enumerate(ranks):
            assert meta["backend"] == "gloo"
            counts = meta["counts"]
            mine = want[r * rows:(r + 1) * rows]
            # the tall dim split: each rank keeps its rows, no collective
            for name in (f"tall_{n}", f"tall_packed_{n}"):
                assert out[name].shape == (rows, n)
                assert np.all(np.abs(out[name] - mine)
                              <= bound[r * rows:(r + 1) * rows]), name
                assert counts[name] == []
            # K split: the whole product on every rank
            for name in (f"ksplit_{n}", f"ring_{n}"):
                assert out[name].shape == (M, n)
                assert np.all(np.abs(out[name] - want) <= bound), name
            ks = counts[f"ksplit_{n}"]
            assert ops_of(ks) == ["all-reduce"]
            assert ks[0]["bytes"] == M * n * 4
            assert ks[0]["group_size"] == world
            ring = counts[f"ring_{n}"]
            assert ops_of(ring) == ["collective-permute"] * 2 * (world - 1)
            assert not any(x["staged"] for x in ring)   # host tensors
            assert sum(x["bytes"] for x in ring) == (world - 1) * 4 * (
                M * K // world + K // world * n)
    for out, meta in ranks:
        np.testing.assert_array_equal(out["broadcast"], [float(world)] * 3)
        assert ops_of(meta["counts"]["broadcast"]) == ["broadcast"]
