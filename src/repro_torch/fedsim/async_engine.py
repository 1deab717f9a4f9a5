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
from repro_torch.data.partition import FederatedData
from repro_torch.fedsim.simulator import (SimConfig, _fed_arrays,
                                          _local_train_flat, round_draws)
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
        through the agent -> RSU assignment."""
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
    """The fleet buffers plus the in-flight ones.  Agent, RSU and pending
    rows are in the storage dtype; the cloud master is fp32."""
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


def pending_mass(state: AsyncSimState) -> torch.Tensor:
    """Decayed weight still in flight (the conservation bookkeeping)."""
    return (state.pending_w * (state.pending_t > 0)).sum()


def _make_async_round_body(cfg: SimConfig, hp: H2FedParams,
                           het: HeterogeneityModel, fed: FederatedData,
                           spec: FlatSpec, acfg: AsyncConfig, *, device,
                           fused: bool = True,
                           faults: Optional[faults_mod.FaultPlan] = None):
    """The global round: ``(state, draws=None, fault_r=None) -> (state,
    metrics)``, ``hp.lar`` ticks.  Metrics hold per-tick stacks of
    ``absorbed_mass`` (lar, R), ``immediate_mass``, ``due_mass`` and
    ``enqueued_mass`` (with a plan also ``quarantined`` and
    ``blocked_mass``), and the round's ``pending_mass``.  ``fault_r`` is
    given exactly when the round was built with a plan."""
    x_all, y_all, n_per_agent, rsu_assign, spe, n_steps = _fed_arrays(
        cfg, hp, fed, device)
    A, R, N = cfg.n_agents, cfg.n_rsus, spec.n
    decay = acfg.agent_decay(rsu_assign, R)         # scalar or (A,)
    keep = acfg.rsu_keep(R, device)                 # scalar or (R,)
    ce = acfg.cloud_every
    rsus = torch.arange(R, device=device)
    onehot = (rsu_assign[None, :] == rsus[:, None]).float()      # (R, A)

    def segment_sum(w):
        """Per-RSU sums of an (A,) weight, in the one-hot matrix's order."""
        return (onehot * w[None, :]).sum(dim=1)

    def cloud_fire(rsu, macc, cloud):
        if fused:
            return ops.cloud_blend(rsu, macc, cloud)
        new = ops.cloud_agg(rsu, macc)
        return torch.where(macc.sum() > 0, new.float(), cloud)

    def anchored(cloud):
        return spec.to_storage(cloud).expand(R, N).clone()

    def global_round(state: AsyncSimState,
                     draws: Optional[AsyncDraws] = None,
                     fault_r: Optional[dict] = None):
        if (faults is None) != (fault_r is None):
            raise ValueError("fault_r is given exactly when the round was "
                             "built with a fault plan")
        if draws is not None and len(draws) != hp.lar:
            raise ValueError(f"want {hp.lar} injected draws, got {len(draws)}")
        cloud = state.cloud_flat
        if ce:
            # a decoupled cadence: buffers and masses persist across rounds
            rsu, rmass, macc = state.rsu_flat, state.rsu_mass, state.cloud_macc
        else:
            # Alg. 2 l.2: RSUs re-anchor to the cloud at round start
            rsu, rmass, macc = anchored(cloud), torch.zeros(
                R, device=device), torch.zeros(R, device=device)
        conn, agent = state.conn, state.agent_flat
        pend_x, pend_w, pend_t = state.pending_x, state.pending_w, \
            state.pending_t
        gtick = state.tick
        ticks = []
        for i in range(hp.lar):
            f = None
            if faults is not None:
                f = {k: v[i] for k, v in fault_r.items()}
                # a recovering RSU re-anchors to the cloud; its aged
                # content and not-yet-aggregated mass go
                ra = f["reanchor"] > 0
                rsu = torch.where(ra[:, None], anchored(cloud), rsu)
                rmass = torch.where(ra, 0.0, rmass)
                macc = torch.where(ra, 0.0, macc)

            # in-flight countdown: due updates deliver this tick, the rest
            # stay busy and train nothing new
            in_flight = pend_t > 0
            pend_t = (pend_t - 1).clamp_min(0)
            due = in_flight & (pend_t == 0)
            busy = in_flight & ~due
            free = ~busy

            if draws is None:
                conn, mask, active_steps = round_draws(
                    state.gen, conn, het, hp, A, spe)
                delays = sample_latency(state.gen, A, het, device)
            else:
                mask, active_steps, delays = (t.to(device) for t in draws[i])
            if f is not None:
                mask = mask & (f["agent_up"] > 0)    # churned agents
            maskf = mask.float()

            # every free agent trains from its RSU's buffer; busy agents
            # keep their row
            act = torch.where(busy, torch.zeros_like(active_steps),
                              active_steps)
            w_start = rsu.index_select(0, rsu_assign)            # (A, N)
            trained = spec.to_storage(_local_train_flat(
                spec, x_all, y_all, w_start, cloud, hp, n_steps, act,
                cfg.batch))
            if f is not None:
                up_a = f["rsu_up"][rsu_assign]                   # (A,)
                trained = faults_mod.apply_corruption(trained, agent, f)
                trained, okf, nq = screen_updates(
                    trained, w_start, n_per_agent * maskf * free.float() * up_a,
                    nonfinite=faults.guard_nonfinite,
                    norm_clip=faults.norm_clip)
            agent = torch.where(busy[:, None], agent, trained)

            # arrivals: the zero-latency cohort (s(0) == 1) and the due
            # stragglers, absorbed with running cohort-mass accounting
            w_imm = n_per_agent * maskf * free * (delays == 0).float()
            w_due = torch.where(due, pend_w, 0.0)
            if f is not None:
                # uploads to a dark RSU are lost (the in-flight slot frees)
                blocked = ((w_imm + w_due) * (1.0 - up_a)).sum()
                w_imm = w_imm * up_a * okf
                w_due = w_due * up_a
            m_i, m_d = segment_sum(w_imm), segment_sum(w_due)
            if fused:
                rsu, rmass, _ = ops.agg_absorb(
                    ((agent, w_imm), (pend_x, w_due)), rsu_assign, R, rsu,
                    rmass, keep=keep)
            else:
                num_i, _ = ops.masked_scatter_accumulate(agent, w_imm,
                                                         rsu_assign, R)
                num_d, _ = ops.masked_scatter_accumulate(pend_x, w_due,
                                                         rsu_assign, R)
                rsu, rmass = buffer_absorb(rsu, rmass, num_i + num_d,
                                           m_i + m_d, keep=keep)
            macc = macc + m_i + m_d

            # enqueue new in-flight work, its weight decayed by s(d) now
            enq = mask & free & (delays > 0)
            if f is not None:
                enq = enq & (okf > 0)        # quarantined rows never enqueue
            pend_x = torch.where(enq[:, None], trained, pend_x)
            w_enq = n_per_agent * maskf * acfg.weight(delays, decay=decay)
            pend_w = torch.where(enq, w_enq, pend_w)
            pend_t = torch.where(enq, delays, pend_t)

            # the cloud cadence on the global tick clock; a dark RSU's mass
            # is left out of the blend
            gtick += 1
            if ce and gtick % ce == 0:
                cloud = cloud_fire(rsu, macc if f is None
                                   else macc * f["rsu_up"], cloud)
                macc = torch.zeros_like(macc)

            m = {"absorbed_mass": m_i + m_d, "immediate_mass": m_i.sum(),
                 "due_mass": m_d.sum(),
                 "enqueued_mass": torch.where(enq, w_enq, 0.0).sum()}
            if f is not None:
                m["quarantined"], m["blocked_mass"] = nq, blocked
            ticks.append(m)

        if not ce:
            # Alg. 3 l.6 at round end, over the mass of RSUs reachable at
            # the round's last tick
            cloud = cloud_fire(rsu, macc if faults is None
                               else macc * fault_r["rsu_up"][hp.lar - 1],
                               cloud)
            macc = torch.zeros_like(macc)
        out = AsyncSimState(agent_flat=agent, rsu_flat=rsu, rsu_mass=rmass,
                            cloud_flat=cloud, pending_x=pend_x,
                            pending_w=pend_w, pending_t=pend_t, conn=conn,
                            gen=state.gen, cloud_macc=macc, tick=gtick)
        metrics = {k: torch.stack([m[k] for m in ticks]) for k in ticks[0]}
        metrics["pending_mass"] = pending_mass(out)
        return out, metrics

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


def _run_async(res, init_params: Params, *, device,
               eval_fn: Optional[Callable[[Params], float]] = None,
               draws: Optional[Sequence[AsyncDraws]] = None,
               ) -> Tuple[AsyncSimState, Dict[str, np.ndarray]]:
    """``run_scenario``'s async target: the scenario's rounds through the
    tick engine.  History: ``round`` and ``acc``, per-round
    ``absorbed_mass`` and ``pending_mass``, and with a plan
    ``quarantined`` and ``blocked_mass``.  ``draws[r]`` injects round r's
    per-tick triples."""
    s = res.spec
    cfg, hp, het, fed = res.cfg, s.hp, s.het, res.fed
    hp.validate(), het.validate()
    if draws is not None and len(draws) != s.rounds:
        raise ValueError(f"want draws for {s.rounds} rounds, got {len(draws)}")
    acfg = AsyncConfig(staleness_decay=s.staleness_decay, schedule=s.schedule,
                       buffer_keep=s.buffer_keep, cloud_every=s.cloud_every)
    if eval_fn is None and res.test is not None:
        x_test = torch.from_numpy(res.test.x).to(device)
        y_test = torch.from_numpy(res.test.y).to(device=device,
                                                 dtype=torch.long)
        eval_fn = lambda p: float(mlp.accuracy(p, x_test, y_test))  # noqa: E731

    spec = spec_of(init_params, storage_dtype=s.fleet_dtype)
    state = init_async_state(cfg, spec, init_params, device)
    round_fn = make_async_global_round(cfg, hp, het, fed, spec, acfg,
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
