"""The synchronous flat H2-Fed round (paper Algorithms 1-3) on torch.

One global round:

  1. RSUs download the cloud model (Alg. 2 l.2): w_k <- w.
  2. ``lar`` local rounds.  Each one
       a. draws connectivity (CSR/SCD) and completed epochs (FSR),
       b. trains every agent from its RSU row with the dual-proximal
          objective (Alg. 1, Eq. 6): the per-agent gradient of a batched
          MLP, then the ``dual_proximal_sgd`` kernel over all A rows,
       c. aggregates the RSU layer with the ``fused_agg_blend`` kernel
          (Alg. 2 l.8); RSUs with an empty cohort keep their model.
  3. Aggregates the cloud layer over RSUs weighted by the surviving data
     mass (Alg. 3 l.6); if nothing survived the cloud model is kept.

The fleet lives in three buffers: agents ``(A, N)`` and RSUs ``(R, N)`` in
the spec's storage dtype (fp32 or bf16), and the ``(N,)`` fp32 cloud
master.  Parameters are unraveled only for eval.  ``fused=False`` runs the
two-step form (aggregation matmul, then the blend) through the
``weighted_agg_matmul`` kernel.

One round body, ``_make_flat_program``, serves one scenario and a
multi-scenario sweep alike: its state carries a leading scenario axis S
(``FlatSweepState``: agents (S, A, N), RSUs (S, R, N), clouds (S, N), one
``torch.Generator`` a scenario), and every kernel takes all S scenarios
in one launch.  The scenarios' own knobs ride in ``Lanes``; with a
``Cadence`` the local rounds run to the group's bound and a scenario past
its own ``lar`` keeps its state and draws nothing, so each scenario's
generator stream is its sequential run's.  ``_make_flat_round_body`` and
``_run_sync`` run it at S = 1 on the single-scenario ``FlatSimState``.

Parity seam: a round takes ``draws``, one ``(mask (A,) bool, active_steps
(A,) int)`` pair per local round (the program: one such list a scenario),
in place of its own draws.  JAX's threefry draws cannot be reproduced by a
``torch.Generator``, so the parity tests feed the JAX package's draws
through it.

Faults: built with a ``FaultPlan``, the round takes ``fault_r``, its
slice of the lowered schedule, and returns ``(state, {"quarantined"})``.
Churn masks the cohort; corrupted payloads enter after training and
``screen_updates`` scrubs and weight-masks them; uploads to a dark RSU
are dropped.  An empty plan gives ``faults=None``'s result bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core.aggregation import screen_updates
from repro_torch.core.flatten import FlatSpec, Params, spec_of
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.heterogeneity import (ConnState, HeterogeneityModel,
                                            init_conn_state, sample_epochs,
                                            sample_latency,
                                            step_connectivity)
from repro_torch.data.partition import FederatedData
from repro_torch.data.pipeline import agent_minibatch
from repro_torch.kernels import ops
from repro_torch.models import mlp

# one local round's injected draws: (mask (A,) bool, active_steps (A,) int)
Draws = Sequence[Tuple[torch.Tensor, torch.Tensor]]
Hyper = Union[float, torch.Tensor]
TRAIN_SCALARS = ("lr", "mu1", "mu2")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_agents: int = 100
    n_rsus: int = 10
    batch: int = 32
    seed: int = 0
    eval_every: int = 1     # global rounds between test-set evaluations


class SimState(NamedTuple):
    """Dict view of the state (the returned final state)."""
    agent_params: Params    # stacked (A, ...)
    rsu_params: Params      # stacked (R, ...)
    cloud_params: Params
    conn: ConnState
    gen: torch.Generator


class FlatSimState(NamedTuple):
    """One scenario's fleet as three contiguous buffers."""
    agent_flat: torch.Tensor    # (A, N)  storage dtype
    rsu_flat: torch.Tensor      # (R, N)  storage dtype
    cloud_flat: torch.Tensor    # (N,)    fp32 master
    conn: ConnState
    gen: torch.Generator        # the round draws' generator


class FlatSweepState(NamedTuple):
    """S scenarios' fleets, stacked on a leading scenario axis."""
    agent_flat: torch.Tensor    # (S, A, N)  storage dtype
    rsu_flat: torch.Tensor      # (S, R, N)  storage dtype
    cloud_flat: torch.Tensor    # (S, N)     fp32 masters
    conn: ConnState             # (S, A)
    gens: Tuple[torch.Generator, ...]   # one a scenario


class Cadence(NamedTuple):
    """Group-wide bounds of the cadence knobs of a sweep whose scenarios
    differ in ``lar`` / ``local_epochs``: the local rounds (async: ticks)
    run to ``lar`` and a scenario past its own is left as it is; the
    minibatch loop runs to ``local_epochs`` epochs, where the update
    kernel's ``step < active_steps`` leaves the padded steps without
    effect.  ``None`` keeps every scenario's own (equal) cadence."""
    lar: int
    local_epochs: int


class Lanes(NamedTuple):
    """The scenarios of one batched program, lane by lane: each one's
    ``H2FedParams`` and ``HeterogeneityModel`` (its draws and cadence, on
    the host), its cloud cadence (async), and the update's ``lr`` /
    ``mu1`` / ``mu2``, each a float every lane shares (baked) or an (S,)
    fp32 tensor on the device (batched)."""
    hps: Tuple[H2FedParams, ...]
    hets: Tuple[HeterogeneityModel, ...]
    lr: Hyper
    mu1: Hyper
    mu2: Hyper
    cloud_every: Tuple[int, ...] = ()

    @classmethod
    def of(cls, hps: Sequence[H2FedParams],
           hets: Sequence[HeterogeneityModel], *,
           batched: Sequence[str] = (), cloud_every: Sequence[int] = (),
           device=None) -> "Lanes":
        """``batched`` names the training scalars passed as (S,) tensors;
        every other one must be equal in every lane."""
        vals = {}
        for name in TRAIN_SCALARS:
            v = [float(getattr(hp, name)) for hp in hps]
            if name in batched:
                vals[name] = torch.tensor(v, dtype=torch.float32,
                                          device=device)
            elif any(x != v[0] for x in v):
                raise ValueError(f"{name} differs across the scenarios but "
                                 f"is not batched")
            else:
                vals[name] = v[0]
        return cls(tuple(hps), tuple(hets), cloud_every=tuple(cloud_every),
                   **vals)

    @property
    def n(self) -> int:
        return len(self.hps)


class FleetData(NamedTuple):
    """A scenario group's data on the device.  Each block is shared by
    every scenario (no leading axis: one copy whatever S is) or stacked
    (S, ...)."""
    x: torch.Tensor             # (A, n, D) or (S, A, n, D)
    y: torch.Tensor             # (A, n) or (S, A, n), int64
    n_per_agent: torch.Tensor   # (A,) or (S, A), fp32
    rsu_assign: torch.Tensor    # (A,) or (S, A), int64
    spe: int                    # minibatch steps an epoch


# a FederatedData's blocks and their dtypes on the device (None: as is)
FLEET_BLOCKS = {"x": None, "y": torch.long, "n_per_agent": torch.float32,
                "rsu_assign": torch.long}


def block_tensor(name: str, array, device) -> torch.Tensor:
    """One FederatedData block as a tensor on ``device``."""
    t = torch.from_numpy(np.asarray(array))
    return t.to(device=device, dtype=FLEET_BLOCKS[name] or t.dtype)


def _fed_arrays(cfg: SimConfig, fed: FederatedData, device) -> FleetData:
    return FleetData(**{k: block_tensor(k, getattr(fed, k), device)
                        for k in FLEET_BLOCKS},
                     spe=max(int(fed.x.shape[1]) // cfg.batch, 1))


def init_flat_state(cfg: SimConfig, spec: FlatSpec, init_params: Params,
                    device) -> FlatSimState:
    vec = spec.ravel({k: v.to(device) for k, v in init_params.items()})
    sv = spec.to_storage(vec)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    # materialised copies, not expand() views: the kernels need contiguous
    # buffers and a write into an expanded view would hit every row
    return FlatSimState(
        agent_flat=sv.expand(cfg.n_agents, spec.n).clone(),
        rsu_flat=sv.expand(cfg.n_rsus, spec.n).clone(),
        cloud_flat=vec,
        conn=init_conn_state(cfg.n_agents, device),
        gen=gen)


def from_flat_state(spec: FlatSpec, state: FlatSimState) -> SimState:
    return SimState(agent_params=spec.unravel_stacked(state.agent_flat),
                    rsu_params=spec.unravel_stacked(state.rsu_flat),
                    cloud_params=spec.unravel(state.cloud_flat),
                    conn=state.conn, gen=state.gen)


def _batch(state: FlatSimState) -> FlatSweepState:
    """One scenario as a sweep of one (views, no copies)."""
    return FlatSweepState(state.agent_flat[None], state.rsu_flat[None],
                          state.cloud_flat[None],
                          ConnState(state.conn.remaining[None]),
                          (state.gen,))


def lane_state(state: FlatSweepState, s: int) -> FlatSimState:
    """Scenario ``s`` of a sweep state (views)."""
    return FlatSimState(state.agent_flat[s], state.rsu_flat[s],
                        state.cloud_flat[s],
                        ConnState(state.conn.remaining[s]), state.gens[s])


def round_draws(gen: torch.Generator, conn: ConnState,
                het: HeterogeneityModel, hp: H2FedParams, n_agents: int,
                spe: int):
    """One local round's draws: (conn', mask (A,) bool, active_steps (A,)
    int), the CSR/SCD connectivity draw and the FSR-drawn step counts."""
    conn, connected = step_connectivity(gen, conn, het)
    epochs = sample_epochs(gen, n_agents, het, hp.local_epochs,
                           device=conn.remaining.device)
    active_steps = epochs * spe
    return conn, connected & (active_steps > 0), active_steps


def stack_lanes(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-scenario tensors on a new leading axis (a view for one)."""
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


def lane_draws(gens, conn: torch.Tensor, lanes: Lanes, live: Sequence[bool],
               n_agents: int, spe: int, draws, i: int, device,
               latency: bool = False):
    """Local round (tick) ``i``'s draws of every scenario, each from its own
    generator: (conn' (S, A), mask (S, A) bool, active_steps (S, A)[,
    delays (S, A)]).  A scenario past its own cadence (``live`` False)
    draws nothing and gets an empty cohort; injected ``draws[s][i]``
    replace scenario s's own (its connectivity is then left as it was)."""
    conns, masks, acts, delays = [], [], [], []
    for s, on in enumerate(live):
        if not on:
            zeros = torch.zeros(n_agents, dtype=torch.int32, device=device)
            conns.append(conn[s])
            masks.append(zeros > 0)
            acts.append(zeros)
            delays.append(zeros)
            continue
        if draws is None:
            c, m, a = round_draws(gens[s], ConnState(conn[s]), lanes.hets[s],
                                  lanes.hps[s], n_agents, spe)
            conns.append(c.remaining)
            if latency:
                delays.append(sample_latency(gens[s], n_agents,
                                             lanes.hets[s], device))
        else:
            m, a, *d = (t.to(device) for t in draws[s][i])
            conns.append(conn[s])
            delays.extend(d)
        masks.append(m)
        acts.append(a)
    out = (stack_lanes(conns), stack_lanes(masks), stack_lanes(acts))
    return out + (stack_lanes(delays),) if latency else out


def agent_rows(buf: torch.Tensor, rsu_assign: torch.Tensor) -> torch.Tensor:
    """Every agent's RSU row: buf (S, R, ...) gathered by rsu_assign, (A,)
    shared or (S, A) -> (S, A, ...)."""
    if rsu_assign.dim() == 1:
        return buf.index_select(1, rsu_assign)
    idx = rsu_assign.reshape(rsu_assign.shape + (1,) * (buf.dim() - 2))
    return torch.gather(buf, 1, idx.expand(rsu_assign.shape + buf.shape[2:]))


def _as_rows(block: torch.Tensor, S: int, dims: int) -> torch.Tensor:
    """A minibatch block as S*A agent rows: a stacked (S, A, ...) block is
    reshaped; a shared (A, ...) one is broadcast over the scenarios (a view
    at S = 1), so the group's data block itself is never copied."""
    if block.dim() > dims:
        return block.reshape((-1,) + block.shape[2:])
    return block.expand((S,) + block.shape).reshape((-1,) + block.shape[1:])


def _local_train_flat(spec: FlatSpec, data: FleetData, w_start: torch.Tensor,
                      w_cloud: torch.Tensor, lanes: Lanes, n_steps: int,
                      active_steps: torch.Tensor, batch: int) -> torch.Tensor:
    """Every agent of every scenario at once: ``active_steps[s, a]``
    proximal-SGD minibatch steps from its RSU row ``w_start[s, a]`` (steps
    beyond it leave the row as it is).  Compute is fp32 whatever the
    storage dtype; returns (S, A, N) fp32.

    w_start: (S, A, N) storage dtype, also the agent->RSU anchor; w_cloud:
    (S, N) fp32, the anchor every agent of a scenario shares."""
    S, A, N = w_start.shape
    a1 = w_start.reshape(S * A, N)
    w = a1.to(torch.float32, copy=True)
    act = active_steps.reshape(S * A)
    for step in range(n_steps):
        xb, yb = agent_minibatch(data.x, data.y, step, batch)
        g = mlp.grad_stacked(spec, w, _as_rows(xb, S, 3), _as_rows(yb, S, 2))
        # in place: w is this function's own buffer (the JAX scan carry);
        # the anchor w_start is widened in the update, and the kernel forms
        # live = (step < active_steps) itself and reads each row's
        # scenario's cloud row and hyper-parameters
        ops.dual_proximal_sgd(w, g, a1, w_cloud, lr=lanes.lr, mu1=lanes.mu1,
                              mu2=lanes.mu2, active_steps=act, step=step,
                              out=w)
    return w.view(S, A, N)


def lane_mask(live: Sequence[bool], device) -> Optional[torch.Tensor]:
    """(S,) bool of the scenarios still inside their cadence, or None when
    every one is."""
    return None if all(live) else torch.tensor(live, device=device)


def _make_flat_program(cfg: SimConfig, spec: FlatSpec, *, fused: bool = True,
                       cadence: Optional[Cadence] = None,
                       faults: Optional[faults_mod.FaultPlan] = None,
                       ) -> Callable:
    """The global round of S scenarios at once: ``(state, data, lanes,
    draws=None, fault_r=None) -> state``, or ``(state, {"quarantined"
    (S,)})`` when built with a fault plan, whose ``fault_r`` holds the
    round's (S, lar, A) / (S, lar, R) masks.

    ``state`` is a ``FlatSweepState`` and ``data`` a ``FleetData``; the
    round advances the state's generators.  ``fused=True`` runs both
    aggregation layers through the fused aggregate-and-blend kernel,
    ``fused=False`` through the aggregation matmul and a separate blend;
    each is one launch a call for all S scenarios.  ``draws[s]``, when
    given, holds scenario s's injected (mask, active_steps) pairs, one a
    local round of its own cadence."""
    A, R, N = cfg.n_agents, cfg.n_rsus, spec.n

    def global_round(state: FlatSweepState, data: FleetData, lanes: Lanes,
                     draws: Optional[Sequence[Draws]] = None,
                     fault_r: Optional[dict] = None):
        if (faults is None) != (fault_r is None):
            raise ValueError("fault_r is given exactly when the round was "
                             "built with a fault plan")
        S, dev = lanes.n, state.cloud_flat.device
        lars = [hp.lar for hp in lanes.hps]
        L, E = ((cadence.lar, cadence.local_epochs) if cadence is not None
                else (lars[0], lanes.hps[0].local_epochs))
        if max(lars) > L or (cadence is None and min(lars) != L):
            raise ValueError(f"lar {lars} outside the program's bound {L}")
        if draws is not None and [len(d) for d in draws] != lars:
            raise ValueError(f"want {lars} injected draws, got "
                             f"{[len(d) for d in draws]}")
        # Alg. 2 l.2: RSUs replace w_k with the cloud model (materialised)
        rsu = spec.to_storage(state.cloud_flat)[:, None].expand(
            S, R, N).clone()
        conn, agent = state.conn.remaining, state.agent_flat
        masses, nqs = [], []
        for i in range(L):
            live = [i < lar for lar in lars]
            conn, mask, active_steps = lane_draws(
                state.gens, conn, lanes, live, A, data.spe, draws, i, dev)
            if faults is not None:
                f = {k: v[:, i] for k, v in fault_r.items()}
                mask = mask & (f["agent_up"] > 0)    # churned agents
            # Alg. 2 l.5 / Alg. 1 l.1: every agent starts from its RSU row
            w_start = agent_rows(rsu, data.rsu_assign)          # (S, A, N)
            agent_prev = agent
            agent = spec.to_storage(_local_train_flat(
                spec, data, w_start, state.cloud_flat, lanes, E * data.spe,
                active_steps, cfg.batch))
            if faults is not None:
                # corrupted payloads enter after training; the gate scrubs
                # rejected rows before any kernel reads them, and uploads
                # to a dark RSU weigh nothing
                agent = faults_mod.apply_corruption(agent, agent_prev, f)
                up_a = agent_rows(f["rsu_up"], data.rsu_assign)  # (S, A)
                maskf = mask.float()
                agent, okf, nq = screen_updates(
                    agent, w_start, data.n_per_agent * maskf * up_a,
                    nonfinite=faults.guard_nonfinite,
                    norm_clip=faults.norm_clip)
                mask = maskf * up_a * okf
                nqs.append(nq)
            # Alg. 2 l.8: one (R, A) @ (A, N) pass over each fleet
            if fused:
                rsu, mass = ops.agg_blend(agent, data.n_per_agent, mask,
                                          data.rsu_assign, R, rsu)
            else:
                new_rsu, mass = ops.masked_hier_agg(agent, data.n_per_agent,
                                                    mask, data.rsu_assign, R)
                rsu = torch.where((mass > 0)[..., None], new_rsu,
                                  rsu).to(rsu.dtype)
            # a scenario past its own lar drew an empty cohort, so its RSUs
            # kept their rows and its mass and quarantine count are 0; its
            # agents keep their rows too
            on = lane_mask(live, dev)
            if on is not None:
                agent = torch.where(on[:, None, None], agent, agent_prev)
            masses.append(mass)

        # Alg. 3 l.6: cloud aggregation, the (1, R) @ (R, N) pass
        total_mass = torch.stack(masses).sum(dim=0)              # (S, R)
        if fused:
            cloud = ops.cloud_blend(rsu, total_mass, state.cloud_flat)
        else:
            new_cloud = ops.cloud_agg(rsu, total_mass)
            cloud = torch.where(total_mass.sum(dim=-1)[:, None] > 0,
                                new_cloud.float(), state.cloud_flat)
        out = FlatSweepState(agent_flat=agent, rsu_flat=rsu, cloud_flat=cloud,
                             conn=ConnState(conn), gens=state.gens)
        if faults is None:
            return out
        return out, {"quarantined": torch.stack(nqs).sum(dim=0)}

    return global_round


def _make_flat_round_body(cfg: SimConfig, hp: H2FedParams,
                          het: HeterogeneityModel, fed: FederatedData,
                          spec: FlatSpec, *, device, fused: bool = True,
                          faults: Optional[faults_mod.FaultPlan] = None,
                          ) -> Callable[..., FlatSimState]:
    """One scenario's global round: ``(state, draws=None) -> state``; with
    ``faults``, ``(state, draws=None, fault_r) -> (state,
    {"quarantined"})``, where ``fault_r`` holds the round's (lar, A)/(lar,
    R) fault masks.  It is ``_make_flat_program`` at S = 1 on a
    ``FlatSimState``; ``draws``, when given, holds ``hp.lar`` injected
    (mask, active_steps) pairs (the state's connectivity is then left as
    it was)."""
    program = _make_flat_program(cfg, spec, fused=fused, faults=faults)
    data = _fed_arrays(cfg, fed, device)
    lanes = Lanes.of([hp], [het])

    def global_round(state: FlatSimState, draws: Optional[Draws] = None,
                     fault_r: Optional[dict] = None):
        if draws is not None and len(draws) != hp.lar:
            raise ValueError(f"want {hp.lar} injected draws, got {len(draws)}")
        out = program(_batch(state), data, lanes,
                      None if draws is None else [draws],
                      None if fault_r is None else
                      {k: v[None] for k, v in fault_r.items()})
        if faults is None:
            return lane_state(out, 0)
        return lane_state(out[0], 0), {k: v[0] for k, v in out[1].items()}

    return global_round


def _run_sync(res, init_params: Params, *, device,
              eval_fn: Optional[Callable[[Params], float]] = None,
              draws: Optional[Sequence[Draws]] = None,
              ) -> Tuple[SimState, Dict[str, np.ndarray]]:
    """``run_scenario``'s flat target: run the scenario's rounds (the round
    program at S = 1) with the fleet resident in (A, N)/(R, N)/(N,) device
    buffers.  ``draws[r]``, when given, is round r's injected draws.  Only
    the (N,) cloud master is unraveled, for eval."""
    s = res.spec
    cfg, hp, het = res.cfg, s.hp, s.het
    hp.validate(), het.validate()
    if draws is not None and len(draws) != s.rounds:
        raise ValueError(f"want draws for {s.rounds} rounds, got {len(draws)}")
    if eval_fn is None and res.test is not None:
        x_test = torch.from_numpy(res.test.x).to(device)
        y_test = torch.from_numpy(res.test.y).to(device=device,
                                                 dtype=torch.long)
        eval_fn = lambda p: float(mlp.accuracy(p, x_test, y_test))  # noqa: E731

    spec = spec_of(init_params, storage_dtype=s.fleet_dtype)
    state = init_flat_state(cfg, spec, init_params, device)
    round_fn = _make_flat_round_body(cfg, hp, het, res.fed, spec,
                                     device=device, fused=s.fused,
                                     faults=s.faults)
    # the plan lowers once over the run's ticks; each round takes its slice
    sched = (None if s.faults is None else
             s.faults.lower(cfg.n_agents, cfg.n_rsus, s.rounds * hp.lar))
    accs, rounds, quarantined = [], [], []
    for r in range(s.rounds):
        rd = None if draws is None else draws[r]
        if sched is None:
            state = round_fn(state, rd)
        else:
            state, fm = round_fn(state, rd, faults_mod.round_tensors(
                sched, r, hp.lar, device))
            quarantined.append(fm["quarantined"])
        if eval_fn is not None and (r % cfg.eval_every == 0
                                    or r == s.rounds - 1):
            accs.append(float(eval_fn(spec.unravel(state.cloud_flat))))
            rounds.append(r + 1)
    history = {"round": np.asarray(rounds), "acc": np.asarray(accs)}
    if sched is not None:     # read on the host once, after the rounds
        history["quarantined"] = torch.stack(quarantined).cpu().numpy()
    return from_flat_state(spec, state), history
