"""The semi-asynchronous H2-Fed engine on torch.

The synchronous round discards the work of agents that miss the local
round's barrier.  This engine drops the barrier.  Time advances in ticks
(one tick is one local round of the synchronous cadence), and an agent's
finished update arrives at its RSU ``d`` ticks after it was computed,
``d`` drawn per agent and tick by ``heterogeneity.sample_latency``:

* an agent with an update in flight is busy and trains nothing new until
  it delivers, so the in-flight state is three buffers: ``pending_x (A,
  N)``, ``pending_w (A,)`` and ``pending_t (A,)`` (ticks to delivery);
* each tick the RSU layer absorbs what arrives, the zero-latency cohort
  plus the due stragglers, each weighted ``n_a * mask_a * s(d)`` with the
  staleness schedule ``aggregation.staleness_weights`` (scalar or per-RSU
  decay), into a running cohort-mass blend (``buffer_absorb``; ``keep``
  scalar or per RSU, ``keep = 0`` replaces on arrival as the synchronous
  round does).  ``fused=True`` runs the whole layer as one launch of the
  ``fused_agg_blend`` kernel (``ops.agg_absorb`` over the two cohorts);
  ``fused=False`` as two scatter-accumulates (the ``weighted_agg_matmul``
  kernel with an fp32 output), a sum and ``buffer_absorb``;
* the cloud aggregates the RSU buffers every ``cloud_every`` ticks of a
  global tick clock that spans rounds (RSU buffers, their mass and the
  cloud's mass accumulator then persist across rounds), or, with
  ``cloud_every = 0``, once at the end of each round after re-anchoring
  the RSUs to the cloud at its start, as the synchronous round does.

With zero latencies, no decay, ``keep = 0`` and ``cloud_every = 0`` a
round computes what ``engine="flat"`` computes from the same draws.

As in the flat engine, one tick body (``_make_async_program``) serves one
scenario and a multi-scenario sweep: the state carries a leading scenario
axis S (``AsyncSweepState``), each kernel takes all S scenarios in one
launch, and each scenario keeps its own tick clock on the host, so a
tick's "the cloud fires" is a host-built (S,) choice, and with a
``Cadence`` a scenario past its own ``lar`` ticks no further that round.
``cloud_every`` may differ between the scenarios: those at 0 re-anchor
their RSUs at round start and aggregate the cloud at round end, the others
on their own clock.  ``_run_async`` runs the body at S = 1.

On an rsu_sharded ``core.topology.HierarchyTopology`` the same tick
algebra runs one rank a shard (``make_sharded_async_global_round``):
agents and their in-flight rows live with their RSU's pod, the arrivals go
through ``ops.block_local_agg`` summed over the data axis only,
``buffer_absorb`` runs on the pod's ``(R_local, N)`` rows, and only the
cloud cadence reduces across pods.  With no delays it is the flat round,
and in the delayed regime it is this engine's ``fused=False`` tick, to
fp32 tolerance.

Parity seam: ``draws``, one ``(mask (A,) bool, active_steps (A,) int,
delays (A,) int)`` triple per tick, replaces the tick's own draws (the
state's connectivity is then left as it was).  Faults: built with a
``FaultPlan``, the round takes ``fault_r``, its slice of the lowered
schedule.  Churned agents disconnect; corrupted payloads enter after
training and ``screen_updates`` scrubs and weight-masks them, and they
never enqueue; uploads (immediate and due) to a dark RSU are dropped and
counted as ``blocked_mass``; a dark RSU ages under ``keep``, is left out
of cloud aggregation, and re-anchors to the cloud on its recovery tick.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core.aggregation import (buffer_absorb, screen_updates,
                                          staleness_weights)
from repro_torch.core.flatten import FlatSpec, Params, spec_of
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.heterogeneity import (ConnState, HeterogeneityModel,
                                            init_conn_state, sample_latency)
from repro_torch.core.topology import HierarchyTopology
from repro_torch.data.partition import FederatedData
from repro_torch.fedsim import sharded
from repro_torch.fedsim.simulator import (Cadence, FleetData, Lanes,
                                          SimConfig, _fed_arrays,
                                          _local_train_flat, agent_rows,
                                          lane_draws, lane_mask, round_draws)
from repro_torch.kernels import ops
from repro_torch.launch import collectives
from repro_torch.models import mlp

# one tick's injected draws: (mask (A,) bool, active_steps (A,) int,
# delays (A,) int)
AsyncDraws = Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """The staleness algebra and the cloud cadence.  ``staleness_decay``
    and ``buffer_keep`` are a scalar or one value per RSU."""
    staleness_decay: Union[float, Tuple[float, ...]] = 0.5
    schedule: str = "exp"          # "exp" | "poly"
    buffer_keep: Union[float, Tuple[float, ...]] = 0.0
    cloud_every: int = 0           # cloud cadence in global ticks; 0: once
    #                                a round (the synchronous cadence)

    def validate(self) -> "AsyncConfig":
        dec = np.asarray(self.staleness_decay, np.float32)
        keep = np.asarray(self.buffer_keep, np.float32)
        if self.schedule not in ("exp", "poly"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if (dec < 0.0).any() or (self.schedule == "exp"
                                 and (dec > 1.0).any()):
            raise ValueError(f"staleness_decay {self.staleness_decay} out "
                             f"of range for schedule {self.schedule!r}")
        if ((keep < 0.0) | (keep > 1.0)).any():
            raise ValueError(f"buffer_keep {self.buffer_keep} not in [0, 1]")
        if self.cloud_every < 0:
            raise ValueError("cloud_every must be >= 0")
        return self

    @staticmethod
    def _per_rsu(value, n_rsus: int, name: str):
        v = np.asarray(value, np.float32)
        if v.ndim == 0:
            return float(v)
        if v.shape != (n_rsus,):
            raise ValueError(f"{name} vector must have one entry per RSU "
                             f"({n_rsus},), got {v.shape}")
        return torch.from_numpy(v)

    def agent_decay(self, rsu_assign: torch.Tensor, n_rsus: int):
        """Each agent's decay rate: the scalar, or the (R,) vector gathered
        through the agent -> RSU assignment ((A,) or (S, A))."""
        dec = self._per_rsu(self.staleness_decay, n_rsus, "staleness_decay")
        if isinstance(dec, float):
            return dec
        return dec.to(rsu_assign.device)[rsu_assign]

    def rsu_keep(self, n_rsus: int, device=None):
        """Buffer retention: the scalar, or the (R,) vector on ``device``."""
        keep = self._per_rsu(self.buffer_keep, n_rsus, "buffer_keep")
        return keep if isinstance(keep, float) else keep.to(device)

    def weight(self, staleness: torch.Tensor, decay=None) -> torch.Tensor:
        return staleness_weights(
            staleness, schedule=self.schedule,
            decay=self.staleness_decay if decay is None else decay)


class AsyncSimState(NamedTuple):
    """One scenario's fleet buffers plus the in-flight ones.  Agent, RSU
    and pending rows are in the storage dtype; the cloud master is fp32."""
    agent_flat: torch.Tensor   # (A, N) latest local model per agent
    rsu_flat: torch.Tensor     # (R, N) staleness-buffer models
    rsu_mass: torch.Tensor     # (R,)   running absorbed cohort mass
    cloud_flat: torch.Tensor   # (N,)   fp32 master
    pending_x: torch.Tensor    # (A, N) in-flight update (one per busy agent)
    pending_w: torch.Tensor    # (A,)   its decayed delivery weight
    pending_t: torch.Tensor    # (A,)   int32 ticks to delivery (0: none)
    conn: ConnState
    gen: torch.Generator       # the tick draws' generator
    cloud_macc: torch.Tensor   # (R,)   mass absorbed since the last cloud
    #                                   aggregation
    tick: int                  # global tick clock (the cloud cadence's)


class AsyncSweepState(NamedTuple):
    """S scenarios' ``AsyncSimState`` on a leading scenario axis, with one
    generator and one host tick clock a scenario."""
    agent_flat: torch.Tensor   # (S, A, N)
    rsu_flat: torch.Tensor     # (S, R, N)
    rsu_mass: torch.Tensor     # (S, R)
    cloud_flat: torch.Tensor   # (S, N)
    pending_x: torch.Tensor    # (S, A, N)
    pending_w: torch.Tensor    # (S, A)
    pending_t: torch.Tensor    # (S, A)
    conn: ConnState            # (S, A)
    gens: Tuple[torch.Generator, ...]
    cloud_macc: torch.Tensor   # (S, R)
    ticks: Tuple[int, ...]


# the state's tensors, in the order a round carries them
_CARRY = ("rsu_flat", "rsu_mass", "cloud_flat", "agent_flat", "pending_x",
          "pending_w", "pending_t", "cloud_macc")


def init_async_state(cfg: SimConfig, spec: FlatSpec, init_params: Params,
                     device) -> AsyncSimState:
    vec = spec.ravel({k: v.to(device) for k, v in init_params.items()})
    sv = spec.to_storage(vec)
    a, r, n = cfg.n_agents, cfg.n_rsus, spec.n
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    # materialised copies, not expand() views (as init_flat_state)
    return AsyncSimState(
        agent_flat=sv.expand(a, n).clone(),
        rsu_flat=sv.expand(r, n).clone(),
        rsu_mass=torch.zeros(r, device=device),
        cloud_flat=vec,
        pending_x=torch.zeros((a, n), dtype=spec.storage_dtype,
                              device=device),
        pending_w=torch.zeros(a, device=device),
        pending_t=torch.zeros(a, dtype=torch.int32, device=device),
        conn=init_conn_state(a, device),
        gen=gen,
        cloud_macc=torch.zeros(r, device=device),
        tick=0)


def _batch(state: AsyncSimState) -> AsyncSweepState:
    """One scenario as a sweep of one (views, no copies)."""
    return AsyncSweepState(
        **{k: getattr(state, k)[None] for k in _CARRY},
        conn=ConnState(state.conn.remaining[None]), gens=(state.gen,),
        ticks=(state.tick,))


def lane_state(state: AsyncSweepState, s: int) -> AsyncSimState:
    """Scenario ``s`` of a sweep state (views)."""
    return AsyncSimState(**{k: getattr(state, k)[s] for k in _CARRY},
                         conn=ConnState(state.conn.remaining[s]),
                         gen=state.gens[s], tick=state.ticks[s])


def pending_mass(state) -> torch.Tensor:
    """Decayed weight still in flight (the conservation bookkeeping): a
    scalar, or (S,) for a sweep state."""
    return (state.pending_w * (state.pending_t > 0)).sum(dim=-1)


def _select(on: torch.Tensor, new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """Per scenario (``on`` (S,) bool): ``new`` where on, else ``old``."""
    return torch.where(on.reshape(on.shape + (1,) * (new.dim() - 1)), new, old)


def _make_async_program(cfg: SimConfig, spec: FlatSpec, acfg: AsyncConfig,
                        *, fused: bool = True,
                        cadence: Optional[Cadence] = None,
                        faults: Optional[faults_mod.FaultPlan] = None):
    """The global round of S scenarios at once: ``(state, data, lanes,
    draws=None, fault_r=None) -> (state, metrics)``, ticks to each
    scenario's own ``lar`` (the group's bound with a ``Cadence``).
    Metrics hold per-tick stacks of ``absorbed_mass`` (S, lar, R),
    ``immediate_mass``, ``due_mass`` and ``enqueued_mass`` (S, lar) (with a
    plan also ``quarantined`` and ``blocked_mass``), zero past a
    scenario's cadence, and the round's ``pending_mass`` (S,).  ``acfg``'s
    decay, schedule and keep are the group's; each scenario's
    ``cloud_every`` is ``lanes.cloud_every``.  ``fault_r`` (the round's (S,
    lar, A) / (S, lar, R) masks) is given exactly when the round was built
    with a plan; ``draws[s]`` is scenario s's (mask, active_steps, delays)
    triples, one a tick of its own cadence."""
    A, R, N = cfg.n_agents, cfg.n_rsus, spec.n
    rsus = torch.arange(R)

    def global_round(state: AsyncSweepState, data: FleetData, lanes: Lanes,
                     draws: Optional[Sequence[AsyncDraws]] = None,
                     fault_r: Optional[dict] = None):
        if (faults is None) != (fault_r is None):
            raise ValueError("fault_r is given exactly when the round was "
                             "built with a fault plan")
        S, dev = lanes.n, state.cloud_flat.device
        lars, ces = [hp.lar for hp in lanes.hps], lanes.cloud_every
        L, E = ((cadence.lar, cadence.local_epochs) if cadence is not None
                else (lars[0], lanes.hps[0].local_epochs))
        if max(lars) > L or (cadence is None and min(lars) != L):
            raise ValueError(f"lar {lars} outside the program's bound {L}")
        if draws is not None and [len(d) for d in draws] != lars:
            raise ValueError(f"want {lars} injected draws, got "
                             f"{[len(d) for d in draws]}")
        assign, n_a = data.rsu_assign, data.n_per_agent
        decay = acfg.agent_decay(assign, R)         # scalar, (A,) or (S, A)
        keep = acfg.rsu_keep(R, dev)                # scalar or (R,)
        onehot = (assign[..., None, :] == rsus.to(dev)[:, None]).float()

        def segment_sum(w):
            """Per-RSU sums of (S, A) weights, in the one-hot order."""
            return (onehot * w[..., None, :]).sum(dim=-1)

        def cloud_fire(rsu, macc, cloud):
            if fused:
                return ops.cloud_blend(rsu, macc, cloud)
            new = ops.cloud_agg(rsu, macc)
            return torch.where(macc.sum(dim=-1)[:, None] > 0, new.float(),
                               cloud)

        def anchored(cloud):
            return spec.to_storage(cloud)[:, None].expand(S, R, N).clone()

        c = {k: getattr(state, k) for k in _CARRY}
        # Alg. 2 l.2 for the scenarios of the synchronous cadence
        # (cloud_every 0): RSUs re-anchor to the cloud at round start; with
        # a decoupled cadence buffers and masses persist across rounds
        anchor = [ce == 0 for ce in ces]
        if any(anchor):
            fresh = {"rsu_flat": anchored(c["cloud_flat"]),
                     "rsu_mass": torch.zeros((S, R), device=dev),
                     "cloud_macc": torch.zeros((S, R), device=dev)}
            on = lane_mask(anchor, dev)
            for k, v in fresh.items():
                c[k] = v if on is None else _select(on, v, c[k])
        conn, ticks, clocks = state.conn.remaining, [], list(state.ticks)
        for i in range(L):
            live = [i < lar for lar in lars]
            before = dict(c)
            f = None
            if faults is not None:
                f = {k: v[:, i] for k, v in fault_r.items()}
                # a recovering RSU re-anchors to the cloud; its aged
                # content and not-yet-aggregated mass go
                ra = f["reanchor"] > 0
                c["rsu_flat"] = torch.where(ra[..., None],
                                            anchored(c["cloud_flat"]),
                                            c["rsu_flat"])
                c["rsu_mass"] = torch.where(ra, 0.0, c["rsu_mass"])
                c["cloud_macc"] = torch.where(ra, 0.0, c["cloud_macc"])

            # in-flight countdown: due updates deliver this tick, the rest
            # stay busy and train nothing new
            pend_t = c["pending_t"]
            in_flight = pend_t > 0
            pend_t = (pend_t - 1).clamp_min(0)
            due = in_flight & (pend_t == 0)
            busy = in_flight & ~due
            free = ~busy

            conn, mask, active_steps, delays = lane_draws(
                state.gens, conn, lanes, live, A, data.spe, draws, i, dev,
                latency=True)
            if f is not None:
                mask = mask & (f["agent_up"] > 0)    # churned agents
            maskf = mask.float()

            # every free agent trains from its RSU's buffer; busy agents
            # keep their row
            act = torch.where(busy, torch.zeros_like(active_steps),
                              active_steps)
            w_start = agent_rows(c["rsu_flat"], assign)          # (S, A, N)
            trained = spec.to_storage(_local_train_flat(
                spec, data, w_start, c["cloud_flat"], lanes, E * data.spe,
                act, cfg.batch))
            if f is not None:
                up_a = agent_rows(f["rsu_up"], assign)           # (S, A)
                trained = faults_mod.apply_corruption(trained,
                                                      c["agent_flat"], f)
                trained, okf, nq = screen_updates(
                    trained, w_start, n_a * maskf * free.float() * up_a,
                    nonfinite=faults.guard_nonfinite,
                    norm_clip=faults.norm_clip)
            c["agent_flat"] = torch.where(busy[..., None], c["agent_flat"],
                                          trained)

            # arrivals: the zero-latency cohort (s(0) == 1) and the due
            # stragglers, absorbed with running cohort-mass accounting
            w_imm = n_a * maskf * free * (delays == 0).float()
            w_due = torch.where(due, c["pending_w"], 0.0)
            if f is not None:
                # uploads to a dark RSU are lost (the in-flight slot frees)
                blocked = ((w_imm + w_due) * (1.0 - up_a)).sum(dim=-1)
                w_imm = w_imm * up_a * okf
                w_due = w_due * up_a
            m_i, m_d = segment_sum(w_imm), segment_sum(w_due)
            if fused:
                c["rsu_flat"], c["rsu_mass"], _ = ops.agg_absorb(
                    ((c["agent_flat"], w_imm), (c["pending_x"], w_due)),
                    assign, R, c["rsu_flat"], c["rsu_mass"], keep=keep)
            else:
                num_i, _ = ops.masked_scatter_accumulate(
                    c["agent_flat"], w_imm, assign, R)
                num_d, _ = ops.masked_scatter_accumulate(
                    c["pending_x"], w_due, assign, R)
                c["rsu_flat"], c["rsu_mass"] = buffer_absorb(
                    c["rsu_flat"], c["rsu_mass"], num_i + num_d, m_i + m_d,
                    keep=keep)
            c["cloud_macc"] = c["cloud_macc"] + m_i + m_d

            # enqueue new in-flight work, its weight decayed by s(d) now
            enq = mask & free & (delays > 0)
            if f is not None:
                enq = enq & (okf > 0)        # quarantined rows never enqueue
            c["pending_x"] = torch.where(enq[..., None], trained,
                                         c["pending_x"])
            w_enq = n_a * maskf * acfg.weight(delays, decay=decay)
            c["pending_w"] = torch.where(enq, w_enq, c["pending_w"])
            c["pending_t"] = torch.where(enq, delays, pend_t)

            # each scenario's cloud cadence on its own global tick clock (a
            # host-built choice); a dark RSU's mass is left out of the blend
            fire = []
            for s, on in enumerate(live):
                clocks[s] += on
                fire.append(on and ces[s] > 0 and clocks[s] % ces[s] == 0)
            if any(fire):
                macc = c["cloud_macc"]
                blended = cloud_fire(c["rsu_flat"], macc if f is None
                                     else macc * f["rsu_up"],
                                     c["cloud_flat"])
                on = lane_mask(fire, dev)
                c["cloud_flat"] = blended if on is None else _select(
                    on, blended, c["cloud_flat"])
                c["cloud_macc"] = (torch.zeros_like(macc) if on is None
                                   else _select(on, 0 * macc, macc))

            m = {"absorbed_mass": m_i + m_d, "immediate_mass": m_i.sum(-1),
                 "due_mass": m_d.sum(-1),
                 "enqueued_mass": torch.where(enq, w_enq, 0.0).sum(-1)}
            if f is not None:
                m["quarantined"], m["blocked_mass"] = nq, blocked
            on = lane_mask(live, dev)
            if on is not None:
                # a scenario past its own lar: this tick never happened
                c = {k: _select(on, v, before[k]) for k, v in c.items()}
                m = {k: _select(on, v, torch.zeros_like(v))
                     for k, v in m.items()}
            ticks.append(m)

        if any(anchor):
            # Alg. 3 l.6 at round end for the synchronous-cadence
            # scenarios, over the mass of RSUs reachable at their last tick
            macc = c["cloud_macc"]
            if faults is not None:
                last = torch.tensor([lar - 1 for lar in lars], device=dev)
                macc = macc * fault_r["rsu_up"][torch.arange(S, device=dev),
                                                last]
            blended = cloud_fire(c["rsu_flat"], macc, c["cloud_flat"])
            on = lane_mask(anchor, dev)
            c["cloud_flat"] = blended if on is None else _select(
                on, blended, c["cloud_flat"])
            c["cloud_macc"] = (torch.zeros_like(macc) if on is None
                               else _select(on, 0 * macc, c["cloud_macc"]))
        out = AsyncSweepState(**c, conn=ConnState(conn), gens=state.gens,
                              ticks=tuple(clocks))
        metrics = {k: torch.stack([m[k] for m in ticks], dim=1)
                   for k in ticks[0]}
        metrics["pending_mass"] = pending_mass(out)
        return out, metrics

    return global_round


def _make_async_round_body(cfg: SimConfig, hp: H2FedParams,
                           het: HeterogeneityModel, fed: FederatedData,
                           spec: FlatSpec, acfg: AsyncConfig, *, device,
                           fused: bool = True,
                           faults: Optional[faults_mod.FaultPlan] = None):
    """One scenario's global round: ``(state, draws=None, fault_r=None) ->
    (state, metrics)``, ``hp.lar`` ticks: ``_make_async_program`` at S = 1
    on an ``AsyncSimState``.  Metrics hold per-tick stacks of
    ``absorbed_mass`` (lar, R), ``immediate_mass``, ``due_mass`` and
    ``enqueued_mass`` (with a plan also ``quarantined`` and
    ``blocked_mass``), and the round's ``pending_mass``.  ``fault_r`` is
    given exactly when the round was built with a plan."""
    program = _make_async_program(cfg, spec, acfg, fused=fused, faults=faults)
    data = _fed_arrays(cfg, fed, device)
    lanes = Lanes.of([hp], [het], cloud_every=[acfg.cloud_every])

    def global_round(state: AsyncSimState,
                     draws: Optional[AsyncDraws] = None,
                     fault_r: Optional[dict] = None):
        if draws is not None and len(draws) != hp.lar:
            raise ValueError(f"want {hp.lar} injected draws, got {len(draws)}")
        out, metrics = program(
            _batch(state), data, lanes, None if draws is None else [draws],
            None if fault_r is None else
            {k: v[None] for k, v in fault_r.items()})
        return lane_state(out, 0), {k: v[0] for k, v in metrics.items()}

    return global_round


def make_async_global_round(cfg: SimConfig, hp: H2FedParams,
                            het: HeterogeneityModel, fed: FederatedData,
                            spec: FlatSpec,
                            acfg: Optional[AsyncConfig] = None, *,
                            device, fused: bool = True,
                            faults: Optional[faults_mod.FaultPlan] = None):
    """The semi-async round with a validated ``AsyncConfig`` (default
    ``AsyncConfig()``); see ``_make_async_round_body``."""
    return _make_async_round_body(cfg, hp, het, fed, spec,
                                  (acfg or AsyncConfig()).validate(),
                                  device=device, fused=fused, faults=faults)


# --------------------------------------------------------------------------
# the rsu-sharded tick loop
# --------------------------------------------------------------------------

def make_sharded_async_global_round(cfg: SimConfig, hp: H2FedParams,
                                    het: HeterogeneityModel,
                                    fed: FederatedData, spec: FlatSpec,
                                    topo: HierarchyTopology,
                                    acfg: Optional[AsyncConfig] = None, *,
                                    device):
    """This rank's semi-async round on an rsu_sharded topology: ``(state,
    draws=None) -> (state, metrics)`` on the rank's blocks (agents and
    their in-flight rows in pod-block order, the pod's (R_local, N) buffer,
    its masses and cloud accumulator).  Each tick the arrivals go through
    two ``ops.block_local_agg`` calls (kernel #2 on the card), summed over
    the data axis only, and ``buffer_absorb`` on the pod's rows; only the
    cloud cadence reduces across pods, on the ticks it fires.  Metrics are
    this rank's share: ``absorbed_mass`` (lar, R_local), ``immediate_mass``,
    ``due_mass`` and ``enqueued_mass`` (lar,) and ``pending_mass`` over its
    own agents; summed over the agent axes they are the fleet's.
    ``draws``: ``hp.lar`` (mask, active_steps, delays) triples in the
    original agent order."""
    if not topo.rsu_sharded:
        raise ValueError("make_sharded_async_global_round needs an "
                         "rsu_sharded=True HierarchyTopology "
                         "(use make_async_global_round otherwise)")
    acfg = (acfg or AsyncConfig()).validate()
    A, R = cfg.n_agents, cfg.n_rsus
    r_loc, rows = topo.rsu_per_pod, topo.rsu_rows()
    local, assign, idx = sharded.local_fleet(cfg, fed, topo, device)
    glob = torch.from_numpy(np.asarray(fed.rsu_assign)).long().to(device)
    decay = acfg.agent_decay(glob, R)
    decay = decay if isinstance(decay, float) else decay.index_select(0, idx)
    keep = acfg.rsu_keep(R, device)
    keep = keep if isinstance(keep, float) else keep[rows]
    storage = spec.storage_dtype
    cloud_reduce = None if storage == torch.float32 else storage
    pod_sum_num = sharded._make_psum_num(storage, topo,
                                         topo.data_shard_axes)
    ce = acfg.cloud_every
    lanes = Lanes.of([hp], [het])
    n_steps = hp.local_epochs * local.spe

    def global_round(state: AsyncSimState,
                     draws: Optional[AsyncDraws] = None):
        if draws is not None and len(draws) != hp.lar:
            raise ValueError(f"want {hp.lar} injected draws, got {len(draws)}")
        # every tick's draws up front, in the replicated original order
        # and the tick engine's sequence, then this rank's rows
        conn, ticks = state.conn, []
        for i in range(hp.lar):
            if draws is None:
                conn, mask, act = round_draws(state.gen, conn, het, hp, A,
                                              local.spe)
                delays = sample_latency(state.gen, A, het, device)
            else:
                mask, act, delays = (t.to(device) for t in draws[i])
            ticks.append(tuple(t.index_select(0, idx)
                               for t in (mask, act, delays)))
        cloud = state.cloud_flat
        if ce:
            # a decoupled cadence: the pod's rows, masses and accumulator
            # persist across rounds
            rsu, rsu_mass, macc = (state.rsu_flat, state.rsu_mass,
                                   state.cloud_macc)
        else:
            rsu = spec.to_storage(cloud)[None].expand(r_loc,
                                                      cloud.numel()).clone()
            rsu_mass = torch.zeros(r_loc, device=device)
            macc = torch.zeros(r_loc, device=device)
        agent, px, pw, pt = (state.agent_flat, state.pending_x,
                             state.pending_w, state.pending_t)
        clock, metrics = state.tick, []
        for mask, act_steps, delays in ticks:
            maskf = mask.float()
            in_flight = pt > 0
            pt = (pt - 1).clamp_min(0)
            due = in_flight & (pt == 0)
            busy = in_flight & ~due
            free = ~busy

            act = torch.where(busy, torch.zeros_like(act_steps), act_steps)
            w_start = rsu.index_select(0, assign)
            trained = spec.to_storage(_local_train_flat(
                spec, local, w_start[None], cloud[None], lanes, n_steps,
                act[None], cfg.batch))[0]
            agent = torch.where(busy[:, None], agent, trained)

            # block-local arrivals, summed over the data axis only
            w_imm = local.n_per_agent * maskf * free * (delays == 0).float()
            w_due = torch.where(due, pw, 0.0)
            num_i, m_i = ops.block_local_agg(agent, w_imm, assign, r_loc)
            num_d, m_d = ops.block_local_agg(px, w_due, assign, r_loc)
            num, m_new = pod_sum_num(num_i + num_d, m_i + m_d)
            rsu, rsu_mass = buffer_absorb(rsu, rsu_mass, num, m_new,
                                          keep=keep)
            macc = macc + m_new

            enq = (maskf > 0) & free & (delays > 0)
            px = torch.where(enq[:, None], trained, px)
            w_enq = local.n_per_agent * maskf * acfg.weight(delays,
                                                            decay=decay)
            pw = torch.where(enq, w_enq, pw)
            pt = torch.where(enq, delays, pt)

            clock += 1
            if ce and clock % ce == 0:
                # the cadence fires: the tick's one collective across pods
                cloud = topo.cloud_psum_mean(macc, rsu, cloud,
                                             reduce_dtype=cloud_reduce)
                macc = torch.zeros_like(macc)
            metrics.append({
                "absorbed_mass": m_i + m_d, "immediate_mass": m_i.sum(),
                "due_mass": m_d.sum(),
                "enqueued_mass": torch.where(enq, w_enq, 0.0).sum()})
        if not ce:
            # the per-round cadence: the round-end cloud aggregation is the
            # round's one collective across pods
            cloud = topo.cloud_psum_mean(macc, rsu, cloud,
                                         reduce_dtype=cloud_reduce)
            macc = torch.zeros_like(macc)
        out = AsyncSimState(agent_flat=agent, rsu_flat=rsu,
                            rsu_mass=rsu_mass, cloud_flat=cloud,
                            pending_x=px, pending_w=pw, pending_t=pt,
                            conn=conn, gen=state.gen, cloud_macc=macc,
                            tick=clock)
        m = {k: torch.stack([t[k] for t in metrics]) for k in metrics[0]}
        m["pending_mass"] = pending_mass(out)
        return out, m

    return global_round


def init_sharded_async_state(cfg: SimConfig, spec: FlatSpec,
                             init_params: Params, topo: HierarchyTopology,
                             device) -> AsyncSimState:
    """This rank's blocks of a fresh async fleet (``init_async_state``'s
    rows: agents and in-flight rows of its shard, its pod's RSUs)."""
    base = sharded.init_sharded_state(cfg, spec, init_params, topo, device)
    a_loc, r_loc = base.agent_flat.shape[0], base.rsu_flat.shape[0]
    return AsyncSimState(
        agent_flat=base.agent_flat, rsu_flat=base.rsu_flat,
        rsu_mass=torch.zeros(r_loc, device=device),
        cloud_flat=base.cloud_flat,
        pending_x=torch.zeros_like(base.agent_flat),
        pending_w=torch.zeros(a_loc, device=device),
        pending_t=torch.zeros(a_loc, dtype=torch.int32, device=device),
        conn=base.conn, gen=base.gen,
        cloud_macc=torch.zeros(r_loc, device=device), tick=0)


def async_config(spec) -> AsyncConfig:
    """The tick engine's config from a spec's async knobs."""
    return AsyncConfig(staleness_decay=spec.staleness_decay,
                       schedule=spec.schedule, buffer_keep=spec.buffer_keep,
                       cloud_every=spec.cloud_every)


def _run_async(res, init_params: Params, *, device,
               eval_fn: Optional[Callable[[Params], float]] = None,
               draws: Optional[Sequence[AsyncDraws]] = None,
               topo: Optional[HierarchyTopology] = None, mesh=None,
               ) -> Tuple[AsyncSimState, Dict[str, np.ndarray]]:
    """``run_scenario``'s async target: the scenario's rounds through the
    tick engine (the tick program at S = 1).  History: ``round`` and
    ``acc``, per-round ``absorbed_mass`` and ``pending_mass``, and with a
    plan ``quarantined`` and ``blocked_mass``.  ``draws[r]`` injects round
    r's per-tick triples.

    An rsu_sharded ``topo``, or a spec with ``rsu_sharded=True`` (its
    topology then built on ``mesh``, by default ``make_fleet_mesh`` over
    the running ranks), runs the rsu-sharded tick loop: agent order is
    converted on entry and exit, and every rank returns the whole fleet
    and the same history."""
    s = res.spec
    cfg, hp, het = res.cfg, s.hp, s.het
    hp.validate(), het.validate()
    if draws is not None and len(draws) != s.rounds:
        raise ValueError(f"want draws for {s.rounds} rounds, got {len(draws)}")
    acfg = async_config(s).validate()
    if eval_fn is None and res.test is not None:
        x_test = torch.from_numpy(res.test.x).to(device)
        y_test = torch.from_numpy(res.test.y).to(device=device,
                                                 dtype=torch.long)
        eval_fn = lambda p: float(mlp.accuracy(p, x_test, y_test))  # noqa: E731
    if topo is None and s.rsu_sharded:
        topo = sharded.resolve_topology(
            cfg, res.fed, sharded.make_fleet_mesh() if mesh is None else mesh,
            rsu_sharded=True)
    if topo is not None:
        return _run_sharded_async(res, init_params, device=device,
                                  eval_fn=eval_fn, draws=draws, topo=topo,
                                  acfg=acfg)

    spec = spec_of(init_params, storage_dtype=s.fleet_dtype)
    state = init_async_state(cfg, spec, init_params, device)
    round_fn = make_async_global_round(cfg, hp, het, res.fed, spec, acfg,
                                       device=device, fused=s.fused,
                                       faults=s.faults)
    sched = (None if s.faults is None else
             s.faults.lower(cfg.n_agents, cfg.n_rsus, s.rounds * hp.lar))
    hist = {k: [] for k in ("round", "acc", "absorbed_mass", "pending_mass",
                            "quarantined", "blocked_mass")}
    for r in range(s.rounds):
        fault_r = (None if sched is None else
                   faults_mod.round_tensors(sched, r, hp.lar, device))
        state, metrics = round_fn(state, None if draws is None else draws[r],
                                  fault_r)
        hist["absorbed_mass"].append(float(metrics["absorbed_mass"].sum()))
        hist["pending_mass"].append(float(metrics["pending_mass"]))
        if sched is not None:
            hist["quarantined"].append(int(metrics["quarantined"].sum()))
            hist["blocked_mass"].append(float(metrics["blocked_mass"].sum()))
        if eval_fn is not None and (r % cfg.eval_every == 0
                                    or r == s.rounds - 1):
            hist["acc"].append(float(eval_fn(spec.unravel(state.cloud_flat))))
            hist["round"].append(r + 1)
    if sched is None:
        del hist["quarantined"], hist["blocked_mass"]
    return state, {k: np.asarray(v) for k, v in hist.items()}


def _run_sharded_async(res, init_params: Params, *, device, eval_fn, draws,
                       topo: HierarchyTopology, acfg: AsyncConfig):
    """``_run_async`` on an rsu_sharded topology.  The per-round metric
    shares are summed over the agent axes once, after the last round."""
    s = res.spec
    cfg, hp = res.cfg, s.hp
    if s.faults is not None:
        raise ValueError("fault injection is not threaded through the "
                         "rsu-sharded path")
    spec = spec_of(init_params, storage_dtype=s.fleet_dtype)
    state = init_sharded_async_state(cfg, spec, init_params, topo, device)
    round_fn = make_sharded_async_global_round(cfg, hp, s.het, res.fed, spec,
                                               topo, acfg, device=device)
    accs, rounds, shares = [], [], []
    for r in range(s.rounds):
        state, metrics = round_fn(state, None if draws is None else draws[r])
        shares.append(torch.stack([metrics["absorbed_mass"].sum(),
                                   metrics["pending_mass"]]))
        if eval_fn is not None and (r % cfg.eval_every == 0
                                    or r == s.rounds - 1):
            accs.append(float(eval_fn(spec.unravel(state.cloud_flat))))
            rounds.append(r + 1)
    totals = collectives.all_reduce(torch.stack(shares), topo.mesh,
                                    topo.agent_axes, where="gather").cpu()
    state = sharded.gather_state(
        state, topo, agent_fields=("agent_flat", "pending_x", "pending_w",
                                   "pending_t"),
        rsu_fields=("rsu_flat", "rsu_mass", "cloud_macc"))
    return state, {"round": np.asarray(rounds), "acc": np.asarray(accs),
                   "absorbed_mass": totals[:, 0].numpy().astype(np.float64),
                   "pending_mass": totals[:, 1].numpy().astype(np.float64)}
