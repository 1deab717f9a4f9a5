"""The continuous serving loop on torch: event-driven H2-Fed ticks.

Every other engine is batch: ``run_scenario`` runs ``rounds`` global
rounds and exits.  This one runs the semi-async engine's tick algebra
(``fedsim/async_engine``) but lets the workload drive time: agent updates
arrive as events from a seeded load generator (``core/load_gen``), queue
in a bounded ``EventQueue`` with an explicit overload policy, and a tick
fires on arrival pressure, queue depth (``batch:K``) or waiting time
(``deadline:W``), instead of on a round counter.  The fp32 cloud master is
copied after every cloud aggregation and served to inference requests
while updates are still being taken in (``CloudModelServer``).

Event lifecycle (one arrival)::

    generator --admit--> EventQueue --drain--> serve tick --> RSU absorb
        | (queue full)       | (same-agent dup)        (weight n*m*s(age))
        +- drop_oldest: evict oldest, dropped += 1
        +- backpressure: defer admission, fire a tick, deferred += 1
        +- coalesce: newest event per agent absorbs, coalesced += rest

Every ``hp.lar`` ticks form one virtual round; with ``cloud_every=0`` the
round close aggregates the cloud and re-anchors the RSUs, the async
engine's round boundary.  Each tick draws connectivity and FSR steps with
``simulator.round_draws`` from the state's generator, as the async engine
does a tick (``sample_latency`` draws nothing when ``max_delay == 0``), so
a run whose generator delivers every agent once per tick window, with
decay disabled, equals ``engine="async"`` to fp32 tolerance.  Arrival
latency is modelled by the queue: an event absorbed ``k`` ticks after its
admission is weighted by the staleness schedule ``s(k)``.

On the card a tick is one ``ops.agg_absorb`` launch of kernel #1 over one
cohort (the arrivals), kernel #3 once a training step, and kernel #1's
``cloud_blend`` at each cloud aggregation; ``fused=False`` runs the
absorb as ``ops.masked_scatter_accumulate`` (kernel #2, fp32 output) and
``buffer_absorb``, and the cloud as ``ops.cloud_agg`` (#2).

Parity seam: ``draws``, one ``(mask (A,) bool, active_steps (A,) int)``
pair per global tick, replaces the tick's own draws (the state's
connectivity is then left as it was); the tests fill it from the JAX
package's key discipline.

Faults: with a ``FaultPlan`` the loop splits it across the host and the
device as the JAX package does.  On the host, seeded per event: clock skew
moves admission times, duplicate admissions re-enter the ingress queue,
churned agents' events are dropped at the door (``events_lost_churn``)
and stale sequence numbers are rejected at drain
(``events_stale_rejected``).  On the device, the tick's slice of the
lowered schedule: corruption of trained rows, the quarantine gate
(``quarantined_updates``), uploads to dark RSUs blocked (``blocked_mass``)
and their held mass left out of every cloud blend, and a recovering RSU
re-anchored to the cloud master.

Crash-resume: ``snapshot_dir`` / ``snapshot_every`` checkpoint the whole
loop state (the buffers, the tick generator's state and ``conn``, queue
and ingress contents, stats, the sim clock, and the count of events pulled
from the generator) through ``checkpoint/ckpt``, so ``resume_from=``
continues the run bit for bit.  An exception or signal mid-loop raises
``ServeLoopInterrupted`` with the final stats, the history and a
last-effort snapshot path.  The snapshots use the JAX package's file
format; its loop cannot read them (its RNG is a key, the port's a
``torch.Generator``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import faults as faults_mod
from repro_torch.core.aggregation import buffer_absorb, screen_updates
from repro_torch.core.flatten import FlatSpec, Params, spec_of
from repro_torch.core.heterogeneity import ConnState
from repro_torch.core.load_gen import (Event, PoissonLoadGen, TickTrigger,
                                       TraceLoadGen, agent_rates,
                                       parse_trigger)
from repro_torch.device import resolve_device
from repro_torch.fedsim.async_engine import (_CARRY, AsyncConfig,
                                             AsyncSimState, async_config,
                                             init_async_state)
from repro_torch.fedsim.simulator import (Lanes, _fed_arrays,
                                          _local_train_flat, round_draws)
from repro_torch.kernels import ops
from repro_torch.models import mlp

OVERLOAD_POLICIES = ("drop_oldest", "backpressure")

# one global tick's injected draws: (mask (A,) bool, active_steps (A,) int)
ServeDraws = Sequence[Tuple[torch.Tensor, torch.Tensor]]


# --------------------------------------------------------------------------
# event queue + overload policy
# --------------------------------------------------------------------------

class EventQueue:
    """Bounded FIFO of admitted events with explicit overload handling.

    ``capacity=0`` is unbounded.  On a full queue, ``drop_oldest`` evicts
    the head (and counts it); ``backpressure`` refuses admission, and the
    caller fires a tick to free space and retries (the generator is pulled,
    so deferral stalls admission without moving sim time).  Entries carry
    their admission tick, so an event's age is ``current_tick -
    admit_tick``.
    """

    def __init__(self, capacity: int = 0, policy: str = "drop_oldest"):
        if policy not in OVERLOAD_POLICIES:
            raise ValueError(f"unknown overload policy {policy!r} "
                             f"(want one of {OVERLOAD_POLICIES})")
        if capacity < 0:
            raise ValueError(f"queue_capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self.policy = policy
        self._q: Deque[Tuple[Event, int]] = deque()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._q)

    @property
    def oldest_t(self) -> float:
        return self._q[0][0].t

    def push(self, ev: Event, tick: int) -> bool:
        """Admit one event; False: refused (backpressure, queue full)."""
        if self.capacity and len(self._q) >= self.capacity:
            if self.policy == "backpressure":
                return False
            self._q.popleft()
            self.dropped += 1
        self._q.append((ev, tick))
        return True

    def drain(self, tick: int) -> Tuple[List[Tuple[Event, int]], int]:
        """Take everything queued, coalescing same-agent duplicates to the
        newest event (highest seq wins, so an injected duplicate of an old
        event never shadows a newer one).  Returns (absorbed [(event,
        age_ticks)] in seq order, n_coalesced)."""
        newest: Dict[int, Tuple[Event, int]] = {}
        n = len(self._q)
        while self._q:
            ev, admit = self._q.popleft()
            held = newest.get(ev.agent)
            if held is None or ev.seq >= held[0].seq:
                newest[ev.agent] = (ev, tick - admit)
        batch = sorted(newest.values(), key=lambda p: p[0].seq)
        return batch, n - len(batch)

    def entries(self) -> List[Tuple[Event, int]]:
        """The queued (event, admit_tick) pairs, head first."""
        return list(self._q)

    def load(self, entries: List[Tuple[Event, int]], dropped: int) -> None:
        """Restore queue contents and the drop counter from a snapshot."""
        self._q = deque(entries)
        self.dropped = int(dropped)


# --------------------------------------------------------------------------
# observability
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ServeLoopStats:
    """Service-level counters and distributions of one serving run."""
    events_generated: int = 0
    events_absorbed: int = 0
    events_dropped: int = 0
    events_deferred: int = 0
    events_coalesced: int = 0
    # fault-injection accounting (all zero on a benign run)
    events_lost_churn: int = 0       # dropped at admission: agent churned
    events_duplicated: int = 0       # duplicate admissions injected
    events_stale_rejected: int = 0   # stale seq rejected at drain
    quarantined_updates: int = 0     # non-finite / norm-clipped updates
    blocked_mass: float = 0.0        # upload mass lost to dark RSUs
    n_ticks: int = 0
    n_rounds: int = 0
    n_cloud_aggs: int = 0
    sim_time: float = 0.0
    wall_s: float = 0.0
    tick_latency_s: List[float] = dataclasses.field(default_factory=list)
    queue_depth: List[int] = dataclasses.field(default_factory=list)
    drain_sizes: List[int] = dataclasses.field(default_factory=list)
    # staleness under load: the sim time each absorbed event waited, its
    # age in ticks (the decay weight's argument), and the served
    # snapshot's age in ticks since the last cloud aggregation
    event_wait: List[float] = dataclasses.field(default_factory=list)
    event_age_ticks: List[int] = dataclasses.field(default_factory=list)
    model_staleness: List[int] = dataclasses.field(default_factory=list)
    serve_requests: int = 0
    serve_latency_s: List[float] = dataclasses.field(default_factory=list)

    def _steady(self) -> List[float]:
        """Tick latencies without the first tick, which carries the
        warm-up (percentiles are a steady-state claim)."""
        return (self.tick_latency_s[1:] if len(self.tick_latency_s) > 1
                else self.tick_latency_s)

    def percentile(self, q: float) -> float:
        lat = self._steady()
        return float(np.percentile(lat, q)) if lat else 0.0

    @property
    def updates_per_s(self) -> float:
        """Sustained absorbed updates a second over steady-state wall."""
        lat = self._steady()
        absorbed = sum(self.drain_sizes[1:] if len(self.drain_sizes) > 1
                       else self.drain_sizes)
        return absorbed / max(sum(lat), 1e-12)

    def summary(self) -> Dict[str, Any]:
        def mean(v):
            return float(np.mean(v)) if v else 0.0

        def most(v, cast):
            return cast(np.max(v)) if v else cast(0)
        return {
            "events_generated": self.events_generated,
            "events_absorbed": self.events_absorbed,
            "events_dropped": self.events_dropped,
            "events_deferred": self.events_deferred,
            "events_coalesced": self.events_coalesced,
            "events_lost_churn": self.events_lost_churn,
            "events_duplicated": self.events_duplicated,
            "events_stale_rejected": self.events_stale_rejected,
            "quarantined_updates": self.quarantined_updates,
            "blocked_mass": self.blocked_mass,
            "n_ticks": self.n_ticks,
            "n_rounds": self.n_rounds,
            "n_cloud_aggs": self.n_cloud_aggs,
            "sim_time": self.sim_time,
            "wall_s": self.wall_s,
            "updates_per_s": self.updates_per_s,
            "tick_p50_ms": self.percentile(50) * 1e3,
            "tick_p99_ms": self.percentile(99) * 1e3,
            "queue_depth_mean": mean(self.queue_depth),
            "queue_depth_max": most(self.queue_depth, int),
            "event_wait_mean": mean(self.event_wait),
            "event_wait_max": most(self.event_wait, float),
            "event_age_ticks_mean": mean(self.event_age_ticks),
            "model_staleness_mean": mean(self.model_staleness),
            "model_staleness_max": most(self.model_staleness, int),
            "serve_requests": self.serve_requests,
            "serve_p50_ms": (float(np.percentile(self.serve_latency_s, 50))
                             * 1e3 if self.serve_latency_s else 0.0),
        }


def _stats_to_tree(stats: ServeLoopStats) -> Dict[str, torch.Tensor]:
    """ServeLoopStats as a flat dict of host tensors (a snapshot leaf):
    ints int64, floats and float lists float64."""
    return {f.name: torch.from_numpy(np.asarray(getattr(stats, f.name)))
            for f in dataclasses.fields(ServeLoopStats)}


def _stats_from_tree(tree: Dict[str, torch.Tensor]) -> ServeLoopStats:
    stats = ServeLoopStats()
    for f in dataclasses.fields(ServeLoopStats):
        v = tree[f.name]
        if f.default is dataclasses.MISSING:        # list-valued field
            setattr(stats, f.name, list(v.tolist()))
        elif isinstance(f.default, int):
            setattr(stats, f.name, int(v))
        else:
            setattr(stats, f.name, float(v))
    return stats


class ServeLoopInterrupted(RuntimeError):
    """Raised when the serve loop dies mid-run (exception or signal).

    The loop finalizes its accounting first: the exception carries the
    ``stats`` and ``history``, the last ``state`` and ``server``, and the
    path of a last-effort snapshot (None if none could be written), so a
    supervisor can ``run_serve_loop(resume_from=...)`` it."""

    def __init__(self, msg: str, *, state=None, history=None, stats=None,
                 server=None, snapshot_path=None):
        super().__init__(msg)
        self.state = state
        self.history = history
        self.stats = stats
        self.server = server
        self.snapshot_path = snapshot_path


class CloudModelServer:
    """Serve the fp32 cloud master while updates are taken in.

    ``publish`` copies the master on its stream, after the work that wrote
    it (the next cloud aggregation writes a new tensor, and the copy must
    not alias the live state); ``request`` enqueues a prediction against
    the current copy on the copy's device and returns the tensor without a
    synchronise, so inference queues behind the tick and never blocks
    admission."""

    def __init__(self, fspec: FlatSpec,
                 predict_fn: Optional[Callable] = None):
        self.fspec = fspec
        self._predict = predict_fn or (
            lambda v, x: mlp.forward(fspec.unravel(v), x).argmax(dim=-1))
        self._snap: Optional[torch.Tensor] = None
        self.published_at_tick: int = 0

    def publish(self, cloud_flat: torch.Tensor, tick: int) -> None:
        self._snap = cloud_flat.clone()
        self.published_at_tick = tick

    @property
    def snapshot(self) -> Optional[torch.Tensor]:
        return self._snap

    def params(self) -> Params:
        """The served model as a parameter dict (the checkpoint boundary)."""
        return self.fspec.unravel(self._snap)

    def request(self, x) -> torch.Tensor:
        if self._snap is None:
            raise RuntimeError("no cloud snapshot published yet")
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.asarray(x))
        return self._predict(self._snap, x.to(self._snap.device))


# --------------------------------------------------------------------------
# the serve tick (the async tick algebra, event-gated)
# --------------------------------------------------------------------------

def _cloud_fire(rsu, macc, cloud, fused: bool) -> torch.Tensor:
    """The cloud aggregation of the RSU buffers over masses ``macc``: the
    master is kept where no mass arrived."""
    if fused:
        return ops.cloud_blend(rsu, macc, cloud)
    new = ops.cloud_agg(rsu, macc)
    return torch.where(macc.sum() > 0, new.float(), cloud)


def _make_serve_tick(cfg, hp, het, fed, spec: FlatSpec, acfg: AsyncConfig,
                     *, device, fused: bool = True,
                     faults: Optional[faults_mod.FaultPlan] = None):
    """One event-driven tick: ``(state, arrive (A,) f32, age (A,) i32,
    f=None, draw=None) -> (state, metrics)``.

    The async engine's tick with the in-flight machinery replaced by the
    event gate: arriving agents train from their RSU row (kernel #3 once a
    step) and are absorbed with weight ``n_a * mask_a * arrive_a *
    s(age_a)``, ``s`` the staleness schedule over the event's queue age in
    ticks; the others keep their row and weigh nothing.  The cloud fires
    every ``cloud_every`` ticks of the global tick clock (``cloud_every =
    0``: at the virtual-round close, ``_make_round_close``).

    Built with ``faults``, the tick takes ``f``, one tick slice of the
    lowered schedule as tensors: recovering RSUs re-anchor to the cloud
    first; trained rows pass ``apply_corruption`` and the
    ``screen_updates`` gate (``metrics["quarantined"]``); uploads to dark
    RSUs are blocked before the mass is counted (``metrics
    ["blocked_mass"]``); a dark RSU's mass sits out the cloud blend.
    ``draw`` is the injected ``(mask, active_steps)`` of this tick.
    Metrics: ``absorbed_mass`` (R,) and ``absorbed_weight``."""
    data = _fed_arrays(cfg, fed, device)
    A, R, N = cfg.n_agents, cfg.n_rsus, spec.n
    assign, n_a = data.rsu_assign, data.n_per_agent
    decay = acfg.agent_decay(assign, R)
    keep = acfg.rsu_keep(R, device)
    ce = acfg.cloud_every
    lanes = Lanes.of([hp], [het])
    n_steps = hp.local_epochs * data.spe
    onehot = (assign[None, :] == torch.arange(R, device=device)[:, None]
              ).float()                                          # (R, A)

    def tick(state: AsyncSimState, arrive: torch.Tensor, age: torch.Tensor,
             f: Optional[dict] = None, draw=None):
        if (faults is None) != (f is None):
            raise ValueError("f is given exactly when the tick was built "
                             "with a fault plan")
        rsu_flat, rsu_mass = state.rsu_flat, state.rsu_mass
        cloud_flat, cloud_macc = state.cloud_flat, state.cloud_macc
        if f is not None:
            # a recovering RSU rejoins at the cloud master, its buffer empty
            ra = f["reanchor"] > 0
            rsu_flat = torch.where(ra[:, None],
                                   spec.to_storage(cloud_flat)[None],
                                   rsu_flat)
            rsu_mass = torch.where(ra, 0.0, rsu_mass)
            cloud_macc = torch.where(ra, 0.0, cloud_macc)

        if draw is None:
            conn, mask, active_steps = round_draws(state.gen, state.conn, het,
                                                   hp, A, data.spe)
        else:
            mask, active_steps = (t.to(device) for t in draw)
            conn = state.conn
        maskf = mask.float()
        arrived = arrive > 0

        # only agents whose update event fired train their drawn steps
        act = torch.where(arrived, active_steps,
                          torch.zeros_like(active_steps))
        w_start = rsu_flat.index_select(0, assign)               # (A, N)
        trained = spec.to_storage(_local_train_flat(
            spec, data, w_start[None], cloud_flat[None], lanes, n_steps,
            act[None], cfg.batch)[0])

        # one cohort, weighted by data volume x connectivity x the
        # staleness schedule over the event's queue age
        w = n_a * maskf * arrive * acfg.weight(age, decay=decay)
        if f is not None:
            up_a = f["rsu_up"][assign]
            trained = faults_mod.apply_corruption(trained, state.agent_flat,
                                                  f)
            trained, okf, n_quar = screen_updates(
                trained, w_start, w * up_a, nonfinite=faults.guard_nonfinite,
                norm_clip=faults.norm_clip)
            blocked = (w * (1.0 - up_a)).sum()
            w = w * up_a * okf
        agent_flat = torch.where(arrived[:, None], trained, state.agent_flat)
        m = (onehot * w).sum(dim=-1)                             # (R,)
        if fused:
            rsu_flat, rsu_mass, _ = ops.agg_absorb(
                ((agent_flat, w),), assign, R, rsu_flat, rsu_mass, keep=keep)
        else:
            num, _ = ops.masked_scatter_accumulate(agent_flat, w, assign, R)
            rsu_flat, rsu_mass = buffer_absorb(rsu_flat, rsu_mass, num, m,
                                               keep=keep)
        cloud_macc = cloud_macc + m

        # the cloud cadence on the global tick clock; a dark RSU's held
        # mass sits out the blend
        gtick = state.tick + 1
        if ce and gtick % ce == 0:
            maccf = cloud_macc if f is None else cloud_macc * f["rsu_up"]
            cloud_flat = _cloud_fire(rsu_flat, maccf, cloud_flat, fused)
            cloud_macc = torch.zeros_like(cloud_macc)

        metrics = {"absorbed_mass": m, "absorbed_weight": w.sum()}
        if f is not None:
            metrics["quarantined"] = n_quar
            metrics["blocked_mass"] = blocked
        out = state._replace(agent_flat=agent_flat, rsu_flat=rsu_flat,
                             rsu_mass=rsu_mass, cloud_flat=cloud_flat,
                             conn=conn, cloud_macc=cloud_macc, tick=gtick)
        return out, metrics

    return tick


def _make_round_close(spec: FlatSpec, n_rsus: int, *, fused: bool = True,
                      faulted: bool = False):
    """The virtual-round close of the per-round cloud cadence
    (``cloud_every = 0``): aggregate the round's absorbed mass into the
    fp32 master, then re-anchor the RSU buffers to it, the async engine's
    round boundary (it re-anchors at round start; the state between rounds
    is the same, and ``init_async_state`` is anchored).

    ``faulted``: the close takes the closing tick's ``rsu_up``; a dark
    RSU's mass sits out the blend and it keeps its buffer (it cannot hear
    the cloud; re-anchoring on recovery is the tick's job)."""

    def close(state: AsyncSimState, up=None) -> AsyncSimState:
        macc = state.cloud_macc if not faulted else state.cloud_macc * up
        cloud = _cloud_fire(state.rsu_flat, macc, state.cloud_flat, fused)
        zeros = torch.zeros_like(state.rsu_mass)
        if faulted:
            upb = up > 0
            return state._replace(
                cloud_flat=cloud,
                rsu_flat=torch.where(upb[:, None],
                                     spec.to_storage(cloud)[None],
                                     state.rsu_flat),
                rsu_mass=torch.where(upb, zeros, state.rsu_mass),
                cloud_macc=torch.where(upb, zeros, state.cloud_macc))
        # a materialised copy: the kernels take contiguous buffers
        anchored = spec.to_storage(cloud)[None].expand(n_rsus,
                                                       spec.n).clone()
        return state._replace(cloud_flat=cloud, rsu_flat=anchored,
                              rsu_mass=zeros, cloud_macc=zeros.clone())

    return close


def _mark(t: torch.Tensor) -> Optional[torch.cuda.Event]:
    """A CUDA event recorded after the work enqueued so far on ``t``'s
    device, or None on the host (where that work is done already)."""
    if not t.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def _wait(ev: Optional[torch.cuda.Event]) -> None:
    if ev is not None:
        ev.synchronize()


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------

def run_serve_loop(res, init_params: Optional[Params] = None, *,
                   device=None,
                   eval_fn: Optional[Callable[[Params], float]] = None,
                   gen=None, probe_x=None,
                   snapshot_dir=None, snapshot_every: int = 0,
                   resume_from=None, resume_step: Optional[int] = None,
                   draws: Optional[ServeDraws] = None,
                   ) -> Tuple[AsyncSimState, Dict[str, Any], ServeLoopStats,
                              CloudModelServer]:
    """Drive a serve-mode scenario end to end on ``device`` (``cuda`` when
    None); returns ``(state, history, stats, server)``.

    ``gen`` overrides the spec's load generator (any object with an
    ``events()`` iterator of ``load_gen.Event``); ``probe_x`` is a request
    batch served against the live snapshot every tick, enqueued after the
    tick and before the loop waits on it.  History holds the per-virtual-
    round ``round`` / ``acc`` and ``absorbed_mass``, and the stats summary
    under ``history["serve"]``.  ``draws[t]`` injects global tick t's
    (mask, active_steps).

    ``snapshot_dir`` + ``snapshot_every=k`` checkpoint the whole loop
    state every k ticks; ``resume_from=<dir>`` restores the latest (or
    ``resume_step``) snapshot and continues the same run: the generator is
    replayed up to the snapshot's event cursor and every later tick
    reproduces the uninterrupted run bit for bit (the same spec and
    generator; pass a trace, not a live Poisson stream, if the run must
    survive the process).  A mid-loop exception or signal raises
    ``ServeLoopInterrupted`` after finalizing the stats and writing a
    last-effort snapshot; a ``ValueError`` (bad input) passes through.
    """
    from repro_torch.core.scenario import ScenarioSpec
    from repro_torch.fedsim.sweep import default_params
    dev = resolve_device(device)
    if isinstance(res, ScenarioSpec):
        res = res.resolve()
    s = res.spec.validate()
    if not s.serve_events and gen is None:
        raise ValueError("run_serve_loop needs spec.serve_events > 0 "
                         "(or an explicit gen)")
    cfg, hp, het, fed = res.cfg, s.hp, s.het, res.fed
    A, lar, ce = cfg.n_agents, hp.lar, s.cloud_every
    plan = s.faults

    if init_params is None:
        init_params = default_params(s, dev)
    fspec = spec_of(init_params, storage_dtype=s.fleet_dtype)
    acfg = async_config(s).validate()
    state = init_async_state(cfg, fspec, init_params, dev)

    trigger: TickTrigger = parse_trigger(s.tick_trigger, A)
    queue = EventQueue(capacity=s.queue_capacity, policy=s.overload_policy)
    if gen is None:
        if s.serve_trace:
            gen = TraceLoadGen.from_jsonl(s.serve_trace,
                                          limit=s.serve_events, n_agents=A)
        else:
            gen = PoissonLoadGen(
                agent_rates(het, A, s.arrival_rate, seed=cfg.seed),
                seed=cfg.seed, n_events=s.serve_events)
    stream = iter(gen.events())

    # the lowered fault schedule over a generous tick bound (ticks past it
    # clip to the last row, so an over-estimate is harmless)
    sched = None
    if plan is not None:
        n_ev = s.serve_events or (len(gen) if hasattr(gen, "__len__") else 0)
        sched = plan.lower(A, cfg.n_rsus, 2 * max(n_ev, 1) + lar + 2)

    tick_fn = _make_serve_tick(cfg, hp, het, fed, fspec, acfg, device=dev,
                               fused=s.fused, faults=plan)
    round_close = _make_round_close(fspec, cfg.n_rsus, fused=s.fused,
                                    faulted=plan is not None)

    if eval_fn is None and res.test is not None:
        x_test = torch.from_numpy(res.test.x).to(dev)
        y_test = torch.from_numpy(res.test.y).to(device=dev, dtype=torch.long)
        eval_fn = lambda p: float(mlp.accuracy(p, x_test, y_test))  # noqa: E731
    server = CloudModelServer(fspec)
    server.publish(state.cloud_flat, 0)
    if probe_x is not None:
        probe_x = (probe_x if torch.is_tensor(probe_x)
                   else torch.from_numpy(np.asarray(probe_x))).to(dev)

    stats = ServeLoopStats()
    tick_in_round = 0
    last_cloud_tick = 0
    accs: List[float] = []
    rounds: List[int] = []
    round_absorbed: List[float] = []
    absorbed_acc = 0.0
    ingress: Deque[Event] = deque()     # deferred + injected-dup events
    last_seq: Dict[int, int] = {}       # per-agent last absorbed seq
    stream_pos = 0                      # events pulled from the generator
    stream_done = False
    now = 0.0
    wall_offset = 0.0

    def f64(rows, width=None) -> torch.Tensor:
        a = np.asarray(rows, np.float64)
        return torch.from_numpy(a if width is None else a.reshape(-1, width))

    def _loop_tree():
        """The whole loop state as one snapshot tree of tensors."""
        return {
            "state": {k: getattr(state, k) for k in _CARRY},
            "conn": state.conn.remaining,
            "gen": state.gen.get_state(),
            "scalars": f64([state.tick, tick_in_round, last_cloud_tick,
                            stream_pos, stream_done, queue.dropped]),
            "clock": f64([now, absorbed_acc,
                          wall_offset + time.perf_counter() - t_loop]),
            "queue": f64([[e.t, e.agent, e.seq, adm]
                          for e, adm in queue.entries()], 4),
            "ingress": f64([[e.t, e.agent, e.seq] for e in ingress], 3),
            "last_seq": torch.from_numpy(np.asarray(
                sorted(last_seq.items()), np.int64).reshape(-1, 2)),
            "accs": f64(accs),
            "rounds": torch.from_numpy(np.asarray(rounds, np.int64)),
            "round_absorbed": f64(round_absorbed),
            "stats": _stats_to_tree(stats),
        }

    t_loop = time.perf_counter()
    if resume_from is not None:
        tree = ckpt.restore(resume_from, step=resume_step, like=_loop_tree(),
                            check_shapes=False)
        state.gen.set_state(tree["gen"])
        sc = tree["scalars"].tolist()
        state = state._replace(conn=ConnState(tree["conn"]), tick=int(sc[0]),
                               **tree["state"])
        tick_in_round = int(sc[1])
        last_cloud_tick = int(sc[2])
        stream_pos = int(sc[3])
        stream_done = bool(sc[4])
        queue.load([(Event(t=r[0], agent=int(r[1]), seq=int(r[2])),
                     int(r[3])) for r in tree["queue"].tolist()],
                   dropped=int(sc[5]))
        ingress.extend(Event(t=r[0], agent=int(r[1]), seq=int(r[2]))
                       for r in tree["ingress"].tolist())
        last_seq.update({int(a): int(q) for a, q in tree["last_seq"].tolist()})
        now, absorbed_acc, wall_offset = tree["clock"].tolist()
        accs = tree["accs"].tolist()
        rounds = [int(v) for v in tree["rounds"].tolist()]
        round_absorbed = tree["round_absorbed"].tolist()
        stats = _stats_from_tree(tree["stats"])
        # replay the generator up to the snapshot's cursor: every event
        # before it was admitted (or deliberately dropped) already
        for _ in range(stream_pos):
            next(stream, None)
        server.publish(state.cloud_flat, last_cloud_tick)

    def _eval_round(r: int):
        if eval_fn is not None:
            accs.append(float(eval_fn(fspec.unravel(state.cloud_flat))))
            rounds.append(r + 1)

    def _next_event() -> Optional[Event]:
        """Pull from the ingress queue first, then the generator, applying
        the plan's per-event seeded clock skew and duplicate injection at
        the generator boundary (stateless: a resumed loop replays them)."""
        nonlocal stream_pos
        if ingress:
            return ingress.popleft()
        ev = next(stream, None)
        if ev is None:
            return None
        stream_pos += 1
        if plan is not None:
            if plan.clock_skew > 0.0:
                ev = Event(t=faults_mod.skewed_time(plan, cfg.seed, ev.seq,
                                                    ev.t),
                           agent=ev.agent, seq=ev.seq)
            for _ in range(faults_mod.duplicate_count(plan, cfg.seed,
                                                      ev.seq)):
                ingress.append(Event(t=ev.t, agent=ev.agent, seq=ev.seq))
                stats.events_duplicated += 1
        return ev

    def _rsu_up_at(t: int) -> torch.Tensor:
        return torch.from_numpy(sched.tick_slice(t)["rsu_up"]).to(dev)

    try:
        while True:
            # ---- admit events until a trigger fires (or the stream ends) --
            while not (stream_done and not ingress):
                if trigger.batch and len(queue) >= trigger.batch:
                    break
                ev = _next_event()
                if ev is None:
                    stream_done = True
                    break
                if not 0 <= ev.agent < A:
                    raise ValueError(
                        f"event agent {ev.agent} outside the fleet "
                        f"(n_agents={A}): a trace from a different "
                        f"scenario?")
                if (sched is not None and sched.agent_up[
                        min(stats.n_ticks, sched.n_ticks - 1),
                        ev.agent] == 0.0):
                    # a churned agent: the event never reaches the queue
                    stats.events_generated += 1
                    stats.events_lost_churn += 1
                    now = max(now, ev.t)
                    continue
                if (trigger.deadline and len(queue)
                        and ev.t - queue.oldest_t >= trigger.deadline):
                    ingress.appendleft(ev)     # fire first, admit after
                    break
                if queue.push(ev, stats.n_ticks):
                    stats.events_generated += 1
                    now = max(now, ev.t)
                else:                          # backpressure: defer + fire
                    ingress.appendleft(ev)
                    stats.events_deferred += 1
                    break
            if not len(queue):
                break                          # stream drained, queue empty

            # ---- drain + fire one tick ------------------------------------
            depth = len(queue)
            batch, coalesced = queue.drain(stats.n_ticks)
            stats.events_coalesced += coalesced
            if plan is not None:
                kept = []
                for e, a_ticks in batch:
                    if e.seq <= last_seq.get(e.agent, -1):
                        stats.events_stale_rejected += 1   # replayed dup
                    else:
                        kept.append((e, a_ticks))
                        last_seq[e.agent] = e.seq
                batch = kept
            arrive = np.zeros((A,), np.float32)
            age = np.zeros((A,), np.int32)
            for e, a_ticks in batch:
                arrive[e.agent] = 1.0
                age[e.agent] = a_ticks
                stats.event_wait.append(now - e.t)
                stats.event_age_ticks.append(a_ticks)
            draw = None
            if draws is not None:
                if stats.n_ticks >= len(draws):
                    raise ValueError(f"injected draws for {len(draws)} "
                                     f"ticks, the loop reached tick "
                                     f"{stats.n_ticks + 1}")
                draw = draws[stats.n_ticks]

            t0 = time.perf_counter()
            fslice = None
            if sched is not None:
                fslice = {k: torch.from_numpy(v).to(dev) for k, v in
                          sched.tick_slice(stats.n_ticks).items()}
            state, tm = tick_fn(state, torch.from_numpy(arrive).to(dev),
                                torch.from_numpy(age).to(dev), fslice, draw)
            done = _mark(state.rsu_mass)
            if probe_x is not None:
                t_req = time.perf_counter()
                preds = server.request(probe_x)    # queued behind the tick
                answered = _mark(preds)
            _wait(done)
            lat = time.perf_counter() - t0
            if probe_x is not None:
                _wait(answered)
                stats.serve_latency_s.append(time.perf_counter() - t_req)
                stats.serve_requests += 1

            absorbed_acc += float(tm["absorbed_weight"])
            if plan is not None:
                stats.quarantined_updates += int(tm["quarantined"])
                stats.blocked_mass += float(tm["blocked_mass"])
            stats.tick_latency_s.append(lat)
            stats.queue_depth.append(depth)
            stats.drain_sizes.append(len(batch))
            stats.events_absorbed += len(batch)
            stats.n_ticks += 1
            tick_in_round += 1
            if ce and stats.n_ticks % ce == 0:
                last_cloud_tick = stats.n_ticks
                stats.n_cloud_aggs += 1
                server.publish(state.cloud_flat, stats.n_ticks)
            stats.model_staleness.append(stats.n_ticks - last_cloud_tick)

            # ---- virtual-round boundary -----------------------------------
            if tick_in_round == lar:
                if not ce:
                    state = round_close(state) if sched is None else \
                        round_close(state, _rsu_up_at(stats.n_ticks - 1))
                    last_cloud_tick = stats.n_ticks
                    stats.n_cloud_aggs += 1
                    server.publish(state.cloud_flat, stats.n_ticks)
                r = stats.n_rounds
                stats.n_rounds += 1
                round_absorbed.append(absorbed_acc)
                absorbed_acc = 0.0
                if r % cfg.eval_every == 0:
                    _eval_round(r)
                tick_in_round = 0

            if (snapshot_dir is not None and snapshot_every
                    and stats.n_ticks % snapshot_every == 0):
                ckpt.save(snapshot_dir, stats.n_ticks, _loop_tree())

    except BaseException as exc:
        if isinstance(exc, ValueError):
            raise   # input / config validation, not an operational failure
        # graceful shutdown: finalize the accounting, write a last-effort
        # snapshot, and hand everything to the caller on the exception
        stats.events_dropped = queue.dropped
        stats.sim_time = now
        stats.wall_s = wall_offset + time.perf_counter() - t_loop
        history = {"round": np.asarray(rounds), "acc": np.asarray(accs),
                   "absorbed_mass": np.asarray(round_absorbed),
                   "serve": stats.summary()}
        snap_path = None
        if snapshot_dir is not None:
            try:
                snap_path = ckpt.save(snapshot_dir, stats.n_ticks,
                                      _loop_tree())
            except Exception:
                snap_path = None
        raise ServeLoopInterrupted(
            f"serve loop interrupted at tick {stats.n_ticks} "
            f"({stats.events_absorbed} events absorbed): {exc!r}",
            state=state, history=history, stats=stats, server=server,
            snapshot_path=snap_path) from exc

    # the partial last round: close it so its absorbed mass reaches the
    # cloud master (then eval once more if the last round was not)
    if tick_in_round:
        if not ce:
            state = round_close(state) if sched is None else \
                round_close(state, _rsu_up_at(stats.n_ticks - 1))
            last_cloud_tick = stats.n_ticks
            stats.n_cloud_aggs += 1
        server.publish(state.cloud_flat, stats.n_ticks)
        r = stats.n_rounds
        stats.n_rounds += 1
        round_absorbed.append(absorbed_acc)
        _eval_round(r)
    elif stats.n_rounds and (rounds == [] or rounds[-1] != stats.n_rounds):
        _eval_round(stats.n_rounds - 1)

    stats.events_dropped = queue.dropped
    stats.sim_time = now
    stats.wall_s = wall_offset + time.perf_counter() - t_loop
    history = {"round": np.asarray(rounds), "acc": np.asarray(accs),
               "absorbed_mass": np.asarray(round_absorbed),
               "serve": stats.summary()}
    if snapshot_dir is not None and snapshot_every:
        ckpt.save(snapshot_dir, stats.n_ticks, _loop_tree())
    return state, history, stats, server


def _run_serve(res, init_params: Params, *, device,
               eval_fn: Optional[Callable[[Params], float]] = None,
               draws: Optional[ServeDraws] = None,
               ) -> Tuple[AsyncSimState, Dict[str, Any]]:
    """``run_scenario``'s serve-mode target (``spec.serve_events > 0``):
    the engines' ``(state, history)`` contract, with the service-level
    summary under ``history["serve"]``."""
    state, history, _, _ = run_serve_loop(res, init_params, device=device,
                                          eval_fn=eval_fn, draws=draws)
    return state, history
