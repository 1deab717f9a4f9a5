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
                                            init_conn_state)
from repro_torch.data.partition import FederatedData
from repro_torch.fedsim.simulator import (Cadence, FleetData, Lanes,
                                          SimConfig, _fed_arrays,
                                          _local_train_flat, agent_rows,
                                          lane_draws, lane_mask)
from repro_torch.kernels import ops
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


def async_config(spec) -> AsyncConfig:
    """The tick engine's config from a spec's async knobs."""
    return AsyncConfig(staleness_decay=spec.staleness_decay,
                       schedule=spec.schedule, buffer_keep=spec.buffer_keep,
                       cloud_every=spec.cloud_every)


def _run_async(res, init_params: Params, *, device,
               eval_fn: Optional[Callable[[Params], float]] = None,
               draws: Optional[Sequence[AsyncDraws]] = None,
               ) -> Tuple[AsyncSimState, Dict[str, np.ndarray]]:
    """``run_scenario``'s async target: the scenario's rounds through the
    tick engine (the tick program at S = 1).  History: ``round`` and
    ``acc``, per-round ``absorbed_mass`` and ``pending_mass``, and with a
    plan ``quarantined`` and ``blocked_mass``.  ``draws[r]`` injects round
    r's per-tick triples."""
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
