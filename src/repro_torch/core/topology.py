"""The hierarchy agents <-> RSUs <-> cloud as one object, bound to a mesh
of ranks (``launch/mesh.FleetMesh``).

``HierarchyTopology`` holds, as the JAX package's does:

* the agent -> RSU assignment (``balanced_assignment`` /
  ``unbalanced_assignment``, the paper's traffic-flow imbalance);
* the mesh layout: ``pod`` <-> RSU groups over the slow link, ``data`` <->
  agents within an RSU group, ``model`` <-> the parameter axis;
* the block structure of the (R, A) aggregation weights: in rsu_sharded
  mode RSU ``r`` lives on pod ``r // rsu_per_pod`` and ``agent_perm``
  co-locates every agent with its RSU's pod, so the weight matrix is
  block-diagonal over pods and the RSU layer is one pod-local ``(R_local,
  A_local) @ (A_local, N)`` product (``kernels/ops.block_local_agg``) with
  no traffic across pods;
* which mesh axes shard each buffer (``agent_spec`` / ``rsu_spec`` /
  ``cloud_spec`` and the N-sharded ``nshard_*``), written as the axis
  entries of a ``PartitionSpec`` (a tuple, one entry a buffer dimension:
  an axis name, a tuple of names, or None for a replicated dimension), and
  the rows and columns of each buffer that this rank holds
  (``agent_rows`` / ``rsu_rows`` / ``model_cols``).

Two modes, as the reference's:

  replicated  (default): the (R, N) RSU buffer is whole on every rank; the
      RSU layer sums over every agent axis.
  rsu_sharded: the RSU axis is split over the pod axis and agents are
      permuted onto their RSU's pod; the RSU layer sums over the data axis
      only, and only the cloud layer (``cloud_psum_mean``) pays a
      collective across pods.

Validation reads only ``mesh.shape`` and ``mesh.axis_names``, so a mesh
stand-in serves the checks and their errors fire before any work.
"""
from __future__ import annotations

from math import prod
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.launch import collectives
from repro_torch.launch.mesh import (AGENT_AXES, FleetMesh, model_axis_size,
                                     world)

LANE = 128      # model shards are lane-aligned: multiples of 128 columns


# --------------------------------------------------------------------------
# agent -> RSU assignment models (paper Sec. III)
# --------------------------------------------------------------------------

def balanced_assignment(n_agents: int, n_rsus: int) -> np.ndarray:
    """Static a -> a mod R assignment (matches the data partitioner)."""
    return (np.arange(n_agents) % n_rsus).astype(np.int32)


def unbalanced_assignment(n_agents: int, n_rsus: int, *, alpha: float = 1.0,
                          seed: int = 0) -> np.ndarray:
    """Dirichlet(alpha) cohort sizes; every RSU keeps >= 1 agent (paper
    Sec. III: "unbalanced agent number at RSUs")."""
    rng = np.random.default_rng(seed)
    props = rng.dirichlet([alpha] * n_rsus)
    counts = np.maximum(np.round(props * n_agents).astype(int), 1)
    while counts.sum() > n_agents:
        counts[np.argmax(counts)] -= 1
    while counts.sum() < n_agents:
        counts[np.argmin(counts)] += 1
    return np.repeat(np.arange(n_rsus), counts).astype(np.int32)


def cohort_sizes(assign: np.ndarray, n_rsus: int) -> np.ndarray:
    return np.bincount(assign, minlength=n_rsus).astype(np.int32)


# --------------------------------------------------------------------------
# the fleet mesh
# --------------------------------------------------------------------------

def make_fleet_mesh(n_devices: Optional[int] = None, *,
                    n_pods: Optional[int] = None,
                    n_model_shards: Optional[int] = None):
    """Lay the fleet out over the ranks (the world size when
    ``n_devices`` is None), with the reference's shapes rule: four or more
    ranks (an even count) get a ('pod', 'data') mesh of 2 x n/2, fewer a
    ('data',) mesh; ``n_pods`` pins the pod axis; ``n_model_shards`` > 1
    appends a trailing ``model`` axis, the parameter axis of the persistent
    (R, N) / (N,) state, with the agent axes over the remaining
    ``n / n_model_shards`` ranks."""
    n = n_devices or world()[1]
    m = int(n_model_shards or 1)
    if m > 1:
        if m < 1 or n % m:
            raise ValueError(
                f"n_model_shards={m} must divide the device count {n}")
        base = n // m
        if n_pods is not None:
            if n_pods < 1 or base % n_pods:
                raise ValueError(
                    f"n_pods={n_pods} must divide the device count {base}")
            return FleetMesh((n_pods, base // n_pods, m),
                             ("pod", "data", "model"))
        if base >= 4 and base % 2 == 0:
            return FleetMesh((2, base // 2, m), ("pod", "data", "model"))
        return FleetMesh((base, m), ("data", "model"))
    if n_pods is not None:
        if n_pods < 1 or n % n_pods:
            raise ValueError(
                f"n_pods={n_pods} must divide the device count {n}")
        return FleetMesh((n_pods, n // n_pods), ("pod", "data"))
    if n >= 4 and n % 2 == 0:
        return FleetMesh((2, n // 2), ("pod", "data"))
    return FleetMesh((n,), ("data",))


# --------------------------------------------------------------------------
# the topology object
# --------------------------------------------------------------------------

class HierarchyTopology:
    """Agent <-> RSU <-> cloud structure bound to a mesh of ranks.

    ``mesh`` is a ``launch.mesh.FleetMesh`` or anything exposing ``.shape``
    (axis -> size) and ``.axis_names``; the engines also read this rank's
    coordinates and groups off a ``FleetMesh``."""

    def __init__(self, n_agents: int, n_rsus: int, mesh, *,
                 rsu_assign: Optional[np.ndarray] = None,
                 rsu_sharded: bool = False):
        if n_agents < 1 or n_rsus < 1:
            raise ValueError(f"need n_agents, n_rsus >= 1 "
                             f"(got {n_agents}, {n_rsus})")
        self.n_agents = int(n_agents)
        self.n_rsus = int(n_rsus)
        self.mesh = mesh
        self.rsu_sharded = bool(rsu_sharded)

        # mesh-derived structure first: the shard-divisibility errors fire
        # before the assignment is looked at
        shape = dict(mesh.shape)
        self.agent_axes: Tuple[str, ...] = tuple(
            a for a in mesh.axis_names if a in AGENT_AXES)
        if not self.agent_axes:
            raise ValueError(f"mesh {shape} has no agent axes "
                             f"(want some of {AGENT_AXES})")
        self.pod_axis: Optional[str] = \
            "pod" if "pod" in self.agent_axes else None
        self.data_axes: Tuple[str, ...] = tuple(
            a for a in self.agent_axes if a != "pod")
        self.model_axis: Optional[str] = \
            "model" if "model" in mesh.axis_names else None
        self.model_shards = int(model_axis_size(mesh))
        self.n_pods = int(shape.get("pod", 1))
        self.n_shards = int(prod(shape[a] for a in self.agent_axes))
        self.data_shards = self.n_shards // max(self.n_pods, 1)
        if self.n_agents % self.n_shards:
            raise ValueError(
                f"n_agents={self.n_agents} must divide over "
                f"{self.n_shards} shards (mesh {shape})")

        assign = (balanced_assignment(n_agents, n_rsus)
                  if rsu_assign is None
                  else np.asarray(rsu_assign, np.int32))
        if assign.shape != (self.n_agents,):
            raise ValueError(f"rsu_assign must be ({n_agents},), "
                             f"got {assign.shape}")
        if assign.min() < 0 or assign.max() >= n_rsus:
            raise ValueError("rsu_assign ids out of range "
                             f"[0, {n_rsus}): {assign.min()}..{assign.max()}")
        self.rsu_assign = assign

        if self.rsu_sharded:
            if self.n_rsus % self.n_pods:
                raise ValueError(
                    f"rsu_sharded needs the pod axis to divide the RSU "
                    f"axis: n_rsus={self.n_rsus} is not divisible by "
                    f"n_pods={self.n_pods} (mesh {shape})")
            self.rsu_per_pod = self.n_rsus // self.n_pods
            self.pod_of_rsu = (np.arange(self.n_rsus)
                               // self.rsu_per_pod).astype(np.int32)
            pod_of_agent = self.pod_of_rsu[self.rsu_assign]
            counts = np.bincount(pod_of_agent, minlength=self.n_pods)
            if not (counts == counts[0]).all():
                raise ValueError(
                    "rsu_sharded needs equal agents per pod, got "
                    f"per-pod cohorts {counts.tolist()} — rebalance the "
                    "assignment or re-map RSUs to pods")
            if counts[0] % max(self.data_shards, 1):
                raise ValueError(
                    f"agents per pod ({int(counts[0])}) must divide over "
                    f"the data axis ({self.data_shards} shards)")
            # co-locate each agent with its RSU's pod: a stable sort keeps
            # the original relative order inside each pod block
            self.agent_perm = np.argsort(
                pod_of_agent, kind="stable").astype(np.int32)
            self.inv_agent_perm = np.argsort(
                self.agent_perm, kind="stable").astype(np.int32)
            assign_p = self.rsu_assign[self.agent_perm]
            self.local_assign = (
                assign_p - self.pod_of_rsu[assign_p] * self.rsu_per_pod
            ).astype(np.int32)
        else:
            self.rsu_per_pod = self.n_rsus
            self.pod_of_rsu = np.zeros((self.n_rsus,), np.int32)
            self.agent_perm = np.arange(self.n_agents, dtype=np.int32)
            self.inv_agent_perm = self.agent_perm
            self.local_assign = self.rsu_assign

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_mesh(cls, mesh) -> "HierarchyTopology":
        """One agent per (pod, data) mesh position, one RSU per pod: the
        agent's shard is its identity, so the permutation is the
        identity."""
        shape = dict(mesh.shape)
        pods = int(shape.get("pod", 1))
        data = int(prod(shape[a] for a in mesh.axis_names
                        if a in AGENT_AXES and a != "pod"))
        n_agents = pods * data
        assign = np.repeat(np.arange(pods, dtype=np.int32), data)
        return cls(n_agents, max(pods, 1), mesh, rsu_assign=assign,
                   rsu_sharded="pod" in mesh.axis_names)

    # -- which axes shard which buffer -------------------------------------

    @property
    def shard_axes(self):
        """The agent axis name(s): a tuple of names, or one name."""
        return (self.agent_axes if len(self.agent_axes) > 1
                else self.agent_axes[0])

    @property
    def data_shard_axes(self):
        """The within-pod (data) axis name(s); None if the mesh is
        pod-only."""
        if not self.data_axes:
            return None
        return (self.data_axes if len(self.data_axes) > 1
                else self.data_axes[0])

    @property
    def agent_spec(self) -> tuple:
        """(A, ...) buffers: the leading axis over every agent axis."""
        return (self.shard_axes,)

    @property
    def rsu_spec(self) -> tuple:
        """(R, ...) buffers: over the pod axis in rsu_sharded mode, else
        whole on every rank."""
        if self.rsu_sharded and self.pod_axis is not None:
            return (self.pod_axis,)
        return ()

    @property
    def cloud_spec(self) -> tuple:
        """(N,) cloud buffer: whole on every rank of the agent axes."""
        return ()

    def stacked_spec(self, n_leading: int = 1) -> tuple:
        """(T, ..., A, ...) inputs: the agent axis after ``n_leading``
        whole axes."""
        return (None,) * n_leading + (self.shard_axes,)

    # -- N-sharding ----------------------------------------------------------

    def model_pad(self, n: int) -> int:
        """Pad the parameter axis so it splits into lane-aligned
        (multiple-of-128) model shards; identity at model_shards == 1."""
        if self.model_shards <= 1:
            return int(n)
        q = self.model_shards * LANE
        return -(-int(n) // q) * q

    @property
    def nshard_cloud_spec(self) -> tuple:
        """(N,) cloud master: split along N over the model axis."""
        if self.model_axis is None:
            return self.cloud_spec
        return (self.model_axis,)

    @property
    def nshard_rsu_spec(self) -> tuple:
        """(R, N) staleness buffers: N over the model axis, R over the pod
        axis in rsu_sharded mode."""
        if self.model_axis is None:
            return self.rsu_spec
        if self.rsu_sharded and self.pod_axis is not None:
            return (self.pod_axis, self.model_axis)
        return (None, self.model_axis)

    # -- this rank's blocks ------------------------------------------------

    def agent_rows(self) -> slice:
        """This rank's rows of an (A, ...) buffer in pod-block order."""
        a_loc = self.n_agents // self.n_shards
        k = self.mesh.coordinate(self.agent_axes)
        return slice(k * a_loc, (k + 1) * a_loc)

    def rsu_rows(self) -> slice:
        """This rank's rows of an (R, ...) buffer (``rsu_spec``)."""
        if self.rsu_spec:
            p = self.mesh.coordinate(self.pod_axis)
            return slice(p * self.rsu_per_pod, (p + 1) * self.rsu_per_pod)
        return slice(0, self.n_rsus)

    def model_cols(self, n: int) -> slice:
        """This rank's columns of the padded parameter axis
        (``nshard_cloud_spec``); every column at model_shards == 1."""
        n_pad = self.model_pad(n)
        if not self.nshard_cloud_spec:
            return slice(0, n_pad)
        nt = n_pad // self.model_shards
        m = self.mesh.coordinate(self.model_axis)
        return slice(m * nt, (m + 1) * nt)

    def cloud_psum_mean(self, rsu_mass: torch.Tensor, rsu_flat: torch.Tensor,
                        fallback: torch.Tensor, *, reduce_dtype=None,
                        ) -> torch.Tensor:
        """Mass-weighted cloud mean of this rank's RSU block: in
        rsu_sharded mode the one collective across pods of a round.
        rsu_mass: (R_local,); rsu_flat: (R_local, N); returns (N,) fp32,
        ``fallback`` where the global mass is zero.

        ``reduce_dtype`` (the fleet storage dtype) casts the (N,) partial
        sum before the reduction across pods: bf16 halves its bytes, and
        the mass then travels in a second, 4-byte call; None or fp32 keeps
        the exact reduction, the sum and the mass in one call."""
        part = rsu_mass @ rsu_flat.float()
        pmass = rsu_mass.sum()
        if self.rsu_sharded and self.pod_axis is not None:
            if reduce_dtype is None or reduce_dtype == torch.float32:
                both = collectives.all_reduce(
                    torch.cat([part, pmass[None]]), self.mesh,
                    self.pod_axis, where="cloud")
                part, pmass = both[:-1], both[-1]
            else:
                part = collectives.all_reduce(
                    part.to(reduce_dtype), self.mesh, self.pod_axis,
                    where="cloud").float()
                pmass = collectives.all_reduce(pmass, self.mesh,
                                               self.pod_axis, where="cloud")
        safe = torch.where(pmass > 0, pmass, torch.ones_like(pmass))
        return torch.where(pmass > 0, part / safe, fallback)

    # -- block structure ---------------------------------------------------

    def permute_agents(self, arr, axis: int = 0):
        """Reorder an (..., A, ...) array into pod-block agent order."""
        return _take(arr, self.agent_perm, axis)

    def unpermute_agents(self, arr, axis: int = 0):
        """Inverse of ``permute_agents``."""
        return _take(arr, self.inv_agent_perm, axis)

    def describe(self) -> str:
        mode = "rsu_sharded" if self.rsu_sharded else "replicated"
        nshard = (f", model_shards={self.model_shards}"
                  if self.model_shards > 1 else "")
        return (f"HierarchyTopology(A={self.n_agents}, R={self.n_rsus}, "
                f"pods={self.n_pods}, shards={self.n_shards}, "
                f"R_local={self.rsu_per_pod}, mode={mode}{nshard})")

    __repr__ = describe


def _take(arr, idx: np.ndarray, axis: int):
    if isinstance(arr, np.ndarray):
        return np.take(arr, idx, axis=axis)
    return arr.index_select(axis, torch.from_numpy(idx).long().to(arr.device))
