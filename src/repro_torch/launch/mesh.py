"""Meshes: shapes, and a process mesh over ``torch.distributed``.

The port of the reference's ``launch/mesh.py``.  ``make_production_mesh``
and ``make_test_mesh`` stay shapes (a ``sharding/rules.py::Mesh``: the
rules need names and sizes only).  :func:`make_mesh` builds the process
mesh a tensor-parallel engine runs on: one process per mesh position,
its coordinates, and one process group per axis line through it.

* **Ranks.**  From torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
  (``python -m torch.distributed.run --standalone --nproc-per-node 2
  ...``), or, for spawned processes, from explicit ``rank`` /
  ``world_size`` and a file store (``init_file``, a path under the
  checkout's ``build/`` or a test's temporary directory).
* **Device.**  ``device="cuda"`` (the default) takes the card
  ``cuda:{local_rank % device_count}``, so ranks share cards when there
  are more ranks than cards; ``"cpu"`` runs on the host.
* **Backend.**  NCCL when every rank of the host has a card of its own;
  gloo when ranks share a card or run on the CPU (NCCL will not put two
  ranks on one device).  The choice is printed, never made silently.
* **Groups.**  ``torch.distributed.new_group`` per axis line, created by
  every rank in the same order.  ``DeviceMesh`` is not used: it sets the
  device from the local rank, which two ranks sharing one card break.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 ranks (data, model).  Multi-pod: 2x16x16 =
    512 (pod, data, model), DP across pods."""
    if multi_pod:
        return Mesh.of((2, 16, 16), ("pod", "data", "model"))
    return Mesh.of((16, 16), ("data", "model"))


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    return Mesh.of(tuple(shape), tuple(axes))


def coords_of(rank: int, mesh: Mesh) -> dict:
    """Row-major mesh coordinates of ``rank`` ({axis name: index})."""
    out, rest = {}, rank
    for name, size in reversed(mesh.axes):
        out[name] = rest % size
        rest //= size
    return dict(reversed(list(out.items())))


def rank_of(coords: dict, mesh: Mesh) -> int:
    r = 0
    for name, size in mesh.axes:
        r = r * size + coords[name]
    return r


@dataclasses.dataclass
class ProcessMesh:
    """One rank's view of a process mesh: the mesh's names and sizes
    (``shape`` / ``axis_names``, so the rules take it as a mesh), its
    rank, coordinates, device, backend and axis groups."""
    desc: Mesh
    rank: int
    coords: dict
    device: torch.device
    backend: str
    groups: dict

    @property
    def shape(self) -> dict:
        return self.desc.shape

    @property
    def axis_names(self) -> tuple:
        return self.desc.axis_names

    def group(self, axis: str):
        """The group of this rank's line along ``axis`` (None when the
        mesh has no such axis)."""
        return self.groups.get(axis)

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def choose_backend(device: torch.device, local_world: int) -> tuple:
    """(backend, why): NCCL when every local rank has a card of its own."""
    if device.type != "cuda":
        return "gloo", "ranks run on the CPU"
    cards = torch.cuda.device_count()
    if local_world > cards:
        return "gloo", f"{local_world} ranks share {cards} card(s)"
    return "nccl", f"{local_world} ranks on {cards} card(s), one each"


def make_mesh(shape, axes, *, device="cuda", rank: Optional[int] = None,
              world_size: Optional[int] = None,
              init_file: Optional[str] = None, verbose: bool = True
              ) -> ProcessMesh:
    """Join (or start) the process group and build this rank's mesh."""
    desc = Mesh.of(tuple(shape), tuple(axes))
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", 0))
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    if desc.size != world_size:
        raise ValueError(f"mesh {desc.shape} needs {desc.size} ranks, the "
                         f"world has {world_size}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the mesh on the CPU")
        if device.index is None:
            device = torch.device("cuda",
                                  local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend, why = choose_backend(device, local_world)
    if not dist.is_initialized():
        if init_file is not None:
            init = f"file://{os.path.abspath(init_file)}"
        elif "MASTER_ADDR" in env:
            init = "env://"
        else:
            raise RuntimeError("make_mesh: no rendezvous; run under torchrun "
                               "or pass init_file= with rank= and "
                               "world_size=")
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world_size)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs "
                           f"{dist.get_backend()}, not {backend}")
    coords = coords_of(rank, desc)
    groups = {}
    for i, name in enumerate(desc.axis_names):
        others = [range(s) for j, (_, s) in enumerate(desc.axes) if j != i]
        for rest in itertools.product(*others):
            ranks = []
            for k in range(desc.shape[name]):
                c = list(rest)
                c.insert(i, k)
                ranks.append(rank_of(dict(zip(desc.axis_names, c)), desc))
            g = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                groups[name] = g
    if verbose and rank == 0:
        print(f"mesh {dict(desc.shape)}: {world_size} ranks, backend "
              f"{backend} ({why}), rank 0 on {device}", flush=True)
    return ProcessMesh(desc, rank, coords, device, backend, groups)

