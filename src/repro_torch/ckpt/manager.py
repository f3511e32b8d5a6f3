"""Numpy checkpoints with atomic commit, async save and auto-resume.

The port of the reference's ``ckpt/manager.py``, with its on-disk layout,
so a checkpoint written by either package restores in the other:

    <dir>/step_000000000123.tmp.<pid>.<ns>/   # staged
        proc_000.npz                          # {flat index -> array}
        meta.json                             # step, n_leaves, shapes, dtypes
    <dir>/step_000000000123/                  # atomically renamed when complete
    <dir>/LATEST                              # text file: "step_000000000123"

Leaves are flattened in jax's order (dict keys sorted at every level).
bf16 leaves are stored as a ``uint8`` view with the dtype string
``"bfloat16"``, as the reference writes them (npz holds no bf16), and
are viewed back to ``torch.bfloat16`` on restore.  A save snapshots every
leaf to host memory before it returns; the write runs on a thread, one
at a time.

On a process mesh (``mesh`` and the tree's partition ``specs``) every
rank takes part in gathering each leaf to its full size and rank 0
alone snapshots and writes ``proc_000`` (the reference writes each
host's addressable shards; full leaves keep one layout, which either
package restores).  A restore cuts each full leaf onto the *target*
mesh (``rules.local_shard``), whatever mesh wrote it: a checkpoint from
``data=2`` with FSDP restores at ``model=2`` or on one rank.
:meth:`CheckpointManager.restore_latest` reads the step on rank 0 after
its write in flight is committed and broadcasts it, so every rank waits
for the commit and restores the same step.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.models.param import tree_leaves, tree_unflatten
from repro_torch.sharding.rules import local_shard, spec_leaves


def _to_host(t) -> tuple:
    """(the array npz stores, the leaf's dtype string)."""
    # a copy on the host even for a CPU tensor: the caller updates its
    # state in place while the write runs
    t = torch.as_tensor(t).detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        # the reference's ml_dtypes view: (..., n) bf16 -> (..., 2n) uint8
        return t.reshape(t.shape or (1,)).view(torch.uint8).numpy(), \
            "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, dtype: str, shape):
    """The host tensor of a stored leaf of the full ``shape``."""
    t = torch.from_numpy(np.asarray(arr, order="C"))
    if arr.dtype == np.uint8 and dtype != "uint8":
        if dtype != "bfloat16":
            raise ValueError(f"checkpoint leaf of dtype {dtype!r}")
        t = t.view(torch.bfloat16)
        if t.ndim != len(shape) and t.numel() == math.prod(shape):
            t = t.reshape(shape)               # a 0-d leaf, stored as (2,)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)}, "
                         f"the target's is {tuple(shape)}")
    return t


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, block: bool = False, specs=None,
             mesh=None):
        """Snapshot to host memory synchronously, write to disk async.  On
        a process ``mesh`` ``tree`` holds this rank's pieces under
        ``specs``: every rank must call, and rank 0 writes the full
        leaves."""
        self.wait()  # one in-flight save at a time
        leaves = tree_leaves(tree)
        host, dtypes = [], []
        if mesh is not None:
            from repro_torch.sharding.comm import gather_full
            for x, sp in zip(leaves, spec_leaves(specs)):
                full = gather_full(x, sp, mesh)
                if mesh.rank == 0:
                    a, dt = _to_host(full)
                    host.append(a)
                    dtypes.append(dt)
                del full
            if mesh.rank != 0:
                return
        else:
            for x in leaves:
                a, dt = _to_host(x)
                host.append(a)
                dtypes.append(dt)
        meta = {
            "step": int(step),
            "n_leaves": len(host),
            "shapes": [list(x.shape) for x in host],
            "dtypes": dtypes,
        }

        def _write():
            name = f"step_{step:012d}"
            tmp = self.dir / f"{name}.tmp.{os.getpid()}.{time.time_ns()}"
            tmp.mkdir(parents=True)
            np.savez(tmp / "proc_000.npz",
                     **{str(i): a for i, a in enumerate(host)})
            with open(tmp / "meta.json", "w") as f:
                json.dump(meta, f)
            final = self.dir / name
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)               # atomic commit
            with open(self.dir / "LATEST.tmp", "w") as f:
                f.write(name)
            os.replace(self.dir / "LATEST.tmp", self.dir / "LATEST")
            self._gc()

        if self.async_save and not block:
            def _run():
                try:
                    _write()
                except Exception as e:           # raised again by wait()
                    self._error = e
            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        """Join the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:012d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and "tmp" not in p.name:
                try:
                    out.append(int(p.name.split("_")[1]))
                except (IndexError, ValueError):
                    pass
        return out

    def latest_step(self) -> Optional[int]:
        latest = self.dir / "LATEST"
        if latest.exists():
            name = latest.read_text().strip()
            if (self.dir / name).exists():
                return int(name.split("_")[1])
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, step: int, target_tree, device="cpu", specs=None,
                mesh=None):
        """Rebuild the tree: ``target_tree`` gives the structure and each
        leaf's full shape (its values are not read: tensors on any device,
        ``meta`` ones included); the leaves land on ``device``.  With a
        process ``mesh`` each leaf is cut to this rank's piece under
        ``specs`` (the target's partition specs).  On a mesh, restore a
        step every rank knows to be committed (:meth:`restore_latest`)."""
        self.wait()
        d = self.dir / f"step_{step:012d}"
        with open(d / "meta.json") as f:
            meta = json.load(f)
        data: dict[int, np.ndarray] = {}
        for f in sorted(d.glob("proc_*.npz")):
            with np.load(f) as z:
                for k in z.files:
                    data[int(k)] = z[k]
        refs = tree_leaves(target_tree)
        if len(refs) != meta["n_leaves"]:
            raise ValueError(f"{d}: {meta['n_leaves']} leaves, the target "
                             f"has {len(refs)}")
        sps = (spec_leaves(specs) if mesh is not None
               else [None] * len(refs))
        out = []
        for i, (ref, sp) in enumerate(zip(refs, sps)):
            t = _from_host(data.pop(i), meta["dtypes"][i], ref.shape)
            if sp is not None:
                t = local_shard(t, sp, mesh, mesh.coords)
            out.append(t.to(device))
        return tree_unflatten(target_tree, out)

    def restore_latest(self, target_tree, device="cpu", specs=None,
                       mesh=None):
        """(step, tree) of the latest committed step, or (None, None).  On
        a process ``mesh`` rank 0 reads the step once its own write is
        committed and broadcasts it (``sharding/comm.py::broadcast``)."""
        self.wait()
        step = self.latest_step()
        if mesh is not None:
            from repro_torch.sharding import comm
            t = torch.tensor([-1 if step is None else step],
                             dtype=torch.int64, device=mesh.device)
            step = int(comm.broadcast(t, 0, None)[0])
            step = None if step < 0 else step
        if step is None:
            return None, None
        return step, self.restore(step, target_tree, device, specs, mesh)
