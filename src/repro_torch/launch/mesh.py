"""Rank meshes for the sharded engines, over ``torch.distributed``.

The JAX package drives a device mesh from one process through
``shard_map``; here every rank is a process of its own and runs the same
round on its own shard.  A ``FleetMesh`` is that mesh seen from one rank:
the axis names and sizes (``.shape``, ``.axis_names``, as a JAX mesh
exposes them), this rank's coordinate along each axis, and one process
group an axis.  The axes keep the reference's meaning:

  ``pod``    RSU groups over the slow link (the cloud layer's collective),
  ``data``   agents within an RSU group,
  ``model``  the parameter axis (the N-sharded fleet state),
  ``sweep``  the scenario axis of a sweep laid over the ranks.

Ranks are laid out row-major over the axes, so the last axis varies
fastest.  With no process group (one rank) every group is ``None`` and
every collective is the identity, the reference's one-device mesh.  The
JAX package's ``make_mesh`` and ``shard_map`` have no counterpart: the
groups are ``torch.distributed.device_mesh`` groups, and the round runs
in every rank's process.

``run_ranks`` starts the ranks of one run: one process each through
``torch.multiprocessing.spawn``, a ``FileStore`` in a temporary directory
for the rendezvous (no port, no network), and rank 0's return value
handed back to the caller.  One rank runs in the calling process.

A ``ShapeMesh`` is a mesh of shapes alone: ``.shape`` and ``.axis_names``
and nothing to run a collective on.  ``make_production_mesh`` builds the
reference's 256- and 512-chip meshes that way, for reckoning what each
rank of them would hold (``launch/sharding``, ``launch/dryrun``).
"""
from __future__ import annotations

import datetime
import os
import sys
import tempfile
import traceback
from math import prod
from typing import Any, Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

AGENT_AXES = ("pod", "data")


def agent_axes(mesh) -> tuple:
    """Mesh axes along which federated agents are laid out."""
    return tuple(a for a in mesh.axis_names if a in AGENT_AXES)


def n_agents(mesh) -> int:
    return prod(mesh.shape[a] for a in agent_axes(mesh))


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def world() -> Tuple[int, int]:
    """(rank, world size) of the running process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class FleetMesh:
    """One rank's view of a mesh of ranks on the running process group:
    ``shape`` (axis -> size, in axis order), ``axis_names``, this rank's
    ``coordinate`` and a process group for each axis and for each set of
    axes the engines reduce over.  Without a process group only a mesh of
    one rank can be built, and it holds no groups."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in shape)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {sizes} does not name its axes "
                             f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.size = prod(sizes)
        self.rank, n = world()
        if n != self.size:
            raise ValueError(
                f"a mesh of {self.size} ranks {self.shape} needs a process "
                f"group of that size, got world size {n}; start the ranks "
                f"with repro_torch.launch.mesh.run_ranks")
        self.backend = dist.get_backend() if dist.is_initialized() else None
        coord, r = [], self.rank
        for s in reversed(sizes):
            coord.append(r % s)
            r //= s
        self.coord: Dict[str, int] = dict(zip(self.axis_names,
                                              reversed(coord)))
        self._groups: Dict[Tuple[str, ...], Any] = {}
        if self.backend is not None:
            self._build_groups()

    def _build_groups(self) -> None:
        """One group an axis from ``init_device_mesh``, and one a pair of
        agent axes (pod and data together), built collectively: every rank
        takes part in every group's creation, in the same order."""
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh("cuda" if self.backend == "nccl" else "cpu",
                              tuple(self.shape.values()),
                              mesh_dim_names=self.axis_names)
        for a in self.axis_names:
            self._groups[(a,)] = dm[a].get_group()
        axes = agent_axes(self)
        if len(axes) == 2:
            m = self.size // n_agents(self)
            for j in range(m):
                # the ranks that share every other coordinate (row-major:
                # the agent axes lead, so they share rank % m)
                ranks = [r for r in range(self.size) if r % m == j]
                g = dist.new_group(ranks)
                if self.rank % m == j:
                    self._groups[axes] = g

    def coordinate(self, axes) -> int:
        """This rank's index along ``axes`` (a name or a tuple of names,
        flattened row-major)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coord[a]
        return idx

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return prod(self.shape[a] for a in axes)

    def group(self, axes):
        """The process group spanning ``axes``; ``None`` when they hold one
        rank (every collective over them is then the identity).  Every
        axis in mesh order is the whole process group."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.axis_size(axes) == 1:
            return None
        if axes == self.axis_names:
            return dist.group.WORLD
        return self._groups[axes]

    def describe(self) -> str:
        return (f"FleetMesh({self.shape}, rank {self.rank}, "
                f"backend {self.backend})")

    __repr__ = describe


class ShapeMesh:
    """A mesh of shapes alone: ``shape`` (axis -> size) and ``axis_names``,
    as a JAX ``AbstractMesh`` has them.  It has no ranks and no process
    group, so nothing can run a collective on it; the sharding rules and
    ``NamedSharding.shard_shape`` / ``block`` read it."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = prod(self.shape.values())

    def group(self, axes):
        raise TypeError(f"{self!r} holds shapes alone and cannot run a "
                        f"collective over {axes}")

    def __repr__(self) -> str:
        return f"ShapeMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The reference's production mesh as shapes: (data 16, model 16), 256
    chips, or (pod 2, data 16, model 16), 512 chips."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


# --------------------------------------------------------------------------
# the rank launcher
# --------------------------------------------------------------------------

def _init(backend: str, store_path: str, rank: int, n: int,
          device: str) -> None:
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(rank % cards)
        if n > cards:
            # ranks that share a card each get an equal share of its
            # memory, so one rank's cached blocks cannot starve another
            torch.cuda.set_per_process_memory_fraction(
                0.95 / -(-n // cards), rank % cards)
    store = dist.FileStore(store_path, n)
    # a rank that stops answering fails its peers' collectives in minutes,
    # not at the default half hour
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(minutes=5))


def _rank_main(rank: int, n: int, backend: str, device: str,
               store_path: str, out_path: str, fn: Callable,
               args: tuple) -> None:
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    _init(backend, store_path, rank, n, device)
    try:
        out = fn(*args)
        if rank == 0:
            torch.save(out, out_path)
        dist.barrier()
    except BaseException:
        # spawn reports one failed rank; the others' errors go to stderr
        print(f"rank {rank} of {n} failed:", file=sys.stderr)
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, fn: Callable, *args, backend: str = "gloo",
              device: str = "cpu") -> Any:
    """Run ``fn(*args)`` on ``n`` ranks of one process group and return
    rank 0's result (saved with ``torch.save``, so tensors come back on
    the device they were returned on).

    ``n > 1`` spawns one process a rank (``fn`` and ``args`` must pickle:
    a module-level function).  ``n == 1`` runs ``fn`` in this process
    inside a process group of one rank, which is destroyed after.
    ``backend`` is ``gloo`` (CPU tensors, and CUDA tensors staged through
    the host) or ``nccl`` (one rank a card).  On ``cuda`` rank r uses card
    r mod the card count: ranks that share a card must use ``gloo``, and
    each may allocate an equal share of its memory."""
    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(f"nccl needs one card a rank: {n} ranks, "
                         f"{torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "store")
        if n == 1:
            _init(backend, store_path, 0, 1, device)
            try:
                return fn(*args)
            finally:
                dist.destroy_process_group()
        out_path = os.path.join(tmp, "rank0.pt")
        torch.multiprocessing.spawn(
            _rank_main, args=(n, backend, device, store_path, out_path, fn,
                              args), nprocs=n, join=True)
        return torch.load(out_path, weights_only=False)

