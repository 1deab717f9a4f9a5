"""The sharded flat round: the fleet's agents split over the ranks of a
mesh (``launch/mesh``), laid out by a ``core.topology.HierarchyTopology``.

Every rank runs the same round on its own shard; a collective is a
``torch.distributed`` call on one of the mesh's groups, made through
``launch/collectives`` (which counts it).  Three modes, the reference's
(``repro/fedsim/sharded.py``):

  replicated (default): each rank trains its agents with the flat
      engine's update (kernel #3 a step), aggregates them into a partial
      (R, N) numerator and (R,) mass with ``ops.block_local_agg`` (kernel
      #2 on the card) and sums those over every agent axis, one call a
      local round; the (R, N) RSU buffer and the cloud stay whole on every
      rank, so the cloud layer needs no collective.
  rsu_sharded (``rsu_sharded=True``): agents are permuted onto their
      RSU's pod, so a rank's agents all belong to its pod's ``R_local``
      RSUs; the RSU layer is block-local and sums over the data axis only,
      and the cloud layer (``HierarchyTopology.cloud_psum_mean``) is the
      round's one collective across pods.
  N-sharded (a ``model`` axis, ``model_shards > 1``): the persistent (R,
      N) buffer and the fp32 cloud master live 1/model_shards a rank along
      N.  A round opens with one all-gather of the cloud slices (in the
      storage dtype), trains and aggregates full-N as above, and keeps
      only its own columns of the (R, N) result before the cloud step.  N
      is padded to ``topo.model_pad(n)``; the zero tail stays zero (zero
      gradients, zero anchors) and ``spec.unravel`` ignores it.

Draws (CSR / SCD / FSR) are made on the replicated (A,) state in the
original agent order, from each rank's own copy of the same seeded
``torch.Generator``: every rank draws the same numbers, in the flat
engine's order.  The rsu-sharded modes then take their rows in pod-block
order.  So every mode equals the flat round (``engine="flat"``) to fp32
tolerance on any admissible mesh, and at one rank (no process group, every
collective the identity) it is the reference's one-device anchor.  The
``draws`` seam takes the flat engine's draws.

A rank's state holds its own blocks: agent rows (A_local, N_pad) in
pod-block order, RSU rows (R_local or R, N / model_shards) and the cloud
columns; ``gather_state`` assembles the whole fleet in the original agent
order, as ``_run_sharded`` returns it on every rank.
"""
from __future__ import annotations

from math import prod
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import normalize_blend
from repro_torch.core.flatten import FlatSpec, Params, spec_of
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.heterogeneity import HeterogeneityModel, init_conn_state
from repro_torch.core.topology import HierarchyTopology, make_fleet_mesh
from repro_torch.data.partition import FederatedData
from repro_torch.fedsim.simulator import (Draws, FlatSimState, FleetData,
                                          Lanes, SimConfig, _fed_arrays,
                                          _local_train_flat, round_draws)
from repro_torch.kernels import ops
from repro_torch.launch import collectives
from repro_torch.launch.mesh import agent_axes
from repro_torch.models import mlp


def n_shards(mesh) -> int:
    return prod(mesh.shape[a] for a in agent_axes(mesh))


def resolve_topology(cfg: SimConfig, fed: FederatedData, mesh, *,
                     rsu_sharded: bool = False) -> HierarchyTopology:
    """Bind the fleet to a mesh; a ``HierarchyTopology`` passes through."""
    if isinstance(mesh, HierarchyTopology):
        return mesh
    return HierarchyTopology(cfg.n_agents, cfg.n_rsus, mesh,
                             rsu_assign=np.asarray(fed.rsu_assign),
                             rsu_sharded=rsu_sharded)


def _make_psum_num(storage: torch.dtype, topo: HierarchyTopology, axes):
    """The RSU layer's sum of an (R, N) fp32 numerator and its (R,) mass
    over ``axes`` (inside the local-round loop): the exact fp32 sum as one
    call; with a bf16 fleet the numerator travels in bf16 (half the
    bytes) and the mass in a second call.  The identity when ``axes`` hold
    one rank."""
    if axes is None or topo.mesh.axis_size(axes) == 1:
        return lambda num, mass: (num, mass)
    mesh = topo.mesh

    def psum_num(num, mass):
        if storage == torch.float32:
            both = collectives.all_reduce(torch.cat([num.reshape(-1), mass]),
                                          mesh, axes, where="lar")
            return both[:num.numel()].view(num.shape), both[num.numel():]
        num = collectives.all_reduce(num.to(storage), mesh, axes,
                                     where="lar").float()
        return num, collectives.all_reduce(mass, mesh, axes, where="lar")

    return psum_num


def local_fleet(cfg: SimConfig, fed: FederatedData, topo: HierarchyTopology,
                device) -> Tuple[FleetData, torch.Tensor, torch.Tensor]:
    """This rank's agents: (their data block, their RSU ids in
    ``[0, R_local)``, their indices into the original agent order)."""
    data = _fed_arrays(cfg, fed, device)
    idx = torch.from_numpy(topo.agent_perm[topo.agent_rows()]).long().to(
        device)
    local = FleetData(x=data.x.index_select(0, idx),
                      y=data.y.index_select(0, idx),
                      n_per_agent=data.n_per_agent.index_select(0, idx),
                      rsu_assign=data.rsu_assign.index_select(0, idx),
                      spe=data.spe)
    assign = torch.from_numpy(topo.local_assign[topo.agent_rows()]).long()
    return local, assign.to(device), idx


def init_sharded_state(cfg: SimConfig, spec: FlatSpec, init_params: Params,
                       topo: HierarchyTopology, device) -> FlatSimState:
    """This rank's blocks of a fresh fleet, every row the initial model:
    agents (A_local, N_pad), RSUs (R_local or R, N_pad / model_shards),
    the cloud's columns, and the replicated connectivity and generator."""
    vec = spec.ravel({k: v.to(device) for k, v in init_params.items()})
    vec = torch.nn.functional.pad(vec, (0, topo.model_pad(spec.n) - spec.n))
    cols, rows = topo.model_cols(spec.n), topo.rsu_rows()
    sv = spec.to_storage(vec)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    a_loc = topo.n_agents // topo.n_shards
    return FlatSimState(
        agent_flat=sv.expand(a_loc, sv.numel()).clone(),
        rsu_flat=sv[cols].expand(rows.stop - rows.start,
                                 cols.stop - cols.start).clone(),
        cloud_flat=vec[cols].clone(),
        conn=init_conn_state(cfg.n_agents, device),
        gen=gen)


def pad_model_axis(state: FlatSimState, topo: HierarchyTopology,
                   n: int) -> FlatSimState:
    """Zero-pad the parameter axis of a whole FlatSimState to
    ``topo.model_pad(n)`` (no-op at model_shards == 1); the first ``n``
    columns carry the model, the tail stays zero through every round."""
    pad = topo.model_pad(n) - n
    if pad == 0:
        return state
    return state._replace(**{
        k: torch.nn.functional.pad(getattr(state, k), (0, pad))
        for k in ("agent_flat", "rsu_flat", "cloud_flat")})


def gather_state(state, topo: HierarchyTopology, *,
                 agent_fields: Sequence[str] = ("agent_flat",),
                 rsu_fields: Sequence[str] = ("rsu_flat",)):
    """The whole fleet from every rank's blocks, agents in the original
    order: agent-row fields gathered over the agent axes, RSU-row fields
    over the pod axis (rsu_sharded), and the parameter axis of the RSU
    rows and the cloud over the model axis.  Collectives counted under
    ``gather``; every rank returns the same state."""
    mesh = topo.mesh
    out = {}
    for k in agent_fields:
        v = collectives.all_gather_cat(getattr(state, k), mesh,
                                       topo.agent_axes, where="gather")
        out[k] = topo.unpermute_agents(v)
    for k in rsu_fields:
        v = getattr(state, k)
        if topo.model_axis is not None and v.dim() == 2:
            v = collectives.all_gather_cat(v, mesh, topo.model_axis,
                                           where="gather", dim=1)
        if topo.rsu_sharded and topo.pod_axis is not None:
            v = collectives.all_gather_cat(v, mesh, topo.pod_axis,
                                           where="gather")
        out[k] = v
    if topo.model_axis is not None:
        out["cloud_flat"] = collectives.all_gather_cat(
            state.cloud_flat, mesh, topo.model_axis, where="gather")
    return state._replace(**out)


def make_sharded_global_round(cfg: SimConfig, hp: H2FedParams,
                              het: HeterogeneityModel, fed: FederatedData,
                              spec: FlatSpec, mesh, *, device,
                              rsu_sharded: bool = False) -> Callable:
    """This rank's global round: ``(state, draws=None) -> state`` on the
    rank's blocks (``init_sharded_state``).  ``mesh`` is a mesh or a
    built ``HierarchyTopology``; the mode follows the topology: N-sharded
    with a model axis (the reference's ``_make_nsharded_round``),
    rsu_sharded (``_make_rsu_sharded_round``) or replicated
    (``_make_replicated_round``).  ``draws``, when given, holds ``hp.lar``
    (mask, active_steps) pairs in the original agent order (the flat
    engine's seam; the state's connectivity is then left as it was)."""
    topo = resolve_topology(cfg, fed, mesh, rsu_sharded=rsu_sharded)
    A, storage = cfg.n_agents, spec.storage_dtype
    if topo.rsu_sharded:
        r_loc, agg_axes = topo.rsu_per_pod, topo.data_shard_axes
    else:
        r_loc, agg_axes = cfg.n_rsus, topo.shard_axes
    psum_num = _make_psum_num(storage, topo, agg_axes)
    cloud_reduce = None if storage == torch.float32 else storage
    cols = topo.model_cols(spec.n)
    nshard = topo.model_shards > 1
    local, assign, idx = local_fleet(cfg, fed, topo, device)
    lanes = Lanes.of([hp], [het])
    n_steps = hp.local_epochs * local.spe

    def global_round(state: FlatSimState,
                     draws: Optional[Draws] = None) -> FlatSimState:
        if draws is not None and len(draws) != hp.lar:
            raise ValueError(f"want {hp.lar} injected draws, got {len(draws)}")
        conn, masks, steps = state.conn, [], []
        for i in range(hp.lar):
            if draws is None:
                conn, mask, act = round_draws(state.gen, conn, het, hp, A,
                                              local.spe)
            else:
                mask, act = (t.to(device) for t in draws[i])
            masks.append(mask.index_select(0, idx))
            steps.append(act.index_select(0, idx))
        if nshard:
            # the round's one wide collective: the cloud slices, gathered
            # in the storage dtype, are the full-N reference
            ref = collectives.all_gather_cat(
                spec.to_storage(state.cloud_flat), topo.mesh,
                topo.model_axis, where="round")
            anchor = ref.float()
        else:
            ref, anchor = spec.to_storage(state.cloud_flat), state.cloud_flat
        # Alg. 2 l.2: RSUs replace w_k with the cloud model (materialised)
        rsu = ref[None].expand(r_loc, ref.numel()).clone()
        agent, masses = state.agent_flat, []
        for mask, act in zip(masks, steps):
            # Alg. 2 l.5 / Alg. 1 l.1: every agent starts from its RSU row
            w_start = rsu.index_select(0, assign)
            agent = spec.to_storage(_local_train_flat(
                spec, local, w_start[None], anchor[None], lanes, n_steps,
                act[None], cfg.batch))[0]
            # Alg. 2 l.8: this rank's block of the weight matrix, summed
            # over the ranks that share its RSUs, then normalized
            num, mass = ops.block_local_agg(agent, local.n_per_agent * mask,
                                            assign, r_loc)
            num, mass = psum_num(num, mass)
            rsu = normalize_blend(num, mass, rsu)
            masses.append(mass)
        if nshard:
            # psum-then-slice: only this rank's columns persist
            rsu = rsu[:, cols].contiguous()
        # Alg. 3 l.6: the mass-weighted cloud mean; across pods (the one
        # collective of the layer) in rsu_sharded mode, else local
        cloud = topo.cloud_psum_mean(torch.stack(masses).sum(dim=0), rsu,
                                     state.cloud_flat,
                                     reduce_dtype=cloud_reduce)
        return FlatSimState(agent_flat=agent, rsu_flat=rsu, cloud_flat=cloud,
                            conn=conn, gen=state.gen)

    return global_round


def full_cloud(cloud: torch.Tensor, topo: HierarchyTopology) -> torch.Tensor:
    """The whole (N_pad,) cloud master from this rank's columns."""
    if topo.model_axis is None:
        return cloud
    return collectives.all_gather_cat(cloud, topo.mesh, topo.model_axis,
                                      where="eval")


def _run_sharded(res, init_params: Params, *, device,
                 eval_fn: Optional[Callable[[Params], float]] = None,
                 draws: Optional[Sequence[Draws]] = None, mesh=None,
                 ) -> Tuple[FlatSimState, Dict[str, np.ndarray]]:
    """``run_scenario``'s sharded target: the flat engine's rounds with the
    agents split over ``mesh`` (by default ``make_fleet_mesh`` over the
    running ranks, with the spec's ``model_shards``; a built
    ``HierarchyTopology`` passes through).  Returns the whole fleet in the
    original agent order (with the padded parameter axis when
    N-sharded) and the history, both equal on every rank.  ``draws[r]``
    injects round r's draws."""
    s = res.spec
    cfg, hp, het = res.cfg, s.hp, s.het
    hp.validate(), het.validate()
    if draws is not None and len(draws) != s.rounds:
        raise ValueError(f"want draws for {s.rounds} rounds, got {len(draws)}")
    if mesh is None:
        mesh = make_fleet_mesh(n_model_shards=s.model_shards)
    topo = resolve_topology(cfg, res.fed, mesh, rsu_sharded=s.rsu_sharded)
    if eval_fn is None and res.test is not None:
        x_test = torch.from_numpy(res.test.x).to(device)
        y_test = torch.from_numpy(res.test.y).to(device=device,
                                                 dtype=torch.long)
        eval_fn = lambda p: float(mlp.accuracy(p, x_test, y_test))  # noqa: E731

    spec = spec_of(init_params, storage_dtype=s.fleet_dtype)
    state = init_sharded_state(cfg, spec, init_params, topo, device)
    round_fn = make_sharded_global_round(cfg, hp, het, res.fed, spec, topo,
                                         device=device)
    accs, rounds = [], []
    for r in range(s.rounds):
        state = round_fn(state, None if draws is None else draws[r])
        if eval_fn is not None and (r % cfg.eval_every == 0
                                    or r == s.rounds - 1):
            cloud = full_cloud(state.cloud_flat, topo)
            accs.append(float(eval_fn(spec.unravel(cloud))))
            rounds.append(r + 1)
    history = {"round": np.asarray(rounds), "acc": np.asarray(accs)}
    return gather_state(state, topo), history
