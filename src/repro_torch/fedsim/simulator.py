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

Parity seam: a round takes ``draws``, one ``(mask (A,) bool, active_steps
(A,) int)`` pair per local round, in place of its own draws.  JAX's
threefry draws cannot be reproduced by a ``torch.Generator``, so the
parity tests feed the JAX package's draws through it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.flatten import FlatSpec, Params, spec_of
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.heterogeneity import (ConnState, HeterogeneityModel,
                                            init_conn_state, sample_epochs,
                                            step_connectivity)
from repro_torch.data.partition import FederatedData
from repro_torch.data.pipeline import agent_minibatch
from repro_torch.kernels import ops
from repro_torch.models import mlp

# one local round's injected draws: (mask (A,) bool, active_steps (A,) int)
Draws = Sequence[Tuple[torch.Tensor, torch.Tensor]]


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
    """The whole fleet as three contiguous buffers."""
    agent_flat: torch.Tensor    # (A, N)  storage dtype
    rsu_flat: torch.Tensor      # (R, N)  storage dtype
    cloud_flat: torch.Tensor    # (N,)    fp32 master
    conn: ConnState
    gen: torch.Generator        # the round draws' generator


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


def _local_train_flat(spec: FlatSpec, x: torch.Tensor, y: torch.Tensor,
                      w_start: torch.Tensor, w_cloud: torch.Tensor,
                      hp: H2FedParams, n_steps: int,
                      active_steps: torch.Tensor, batch: int) -> torch.Tensor:
    """Every agent at once: ``active_steps[a]`` proximal-SGD minibatch steps
    from its RSU row ``w_start[a]`` (steps beyond it leave the row as it
    is).  Compute is fp32 whatever the storage dtype; returns (A, N) fp32.

    x: (A, n, D), y: (A, n); w_start: (A, N) storage dtype, also the
    agent->RSU anchor; w_cloud: (N,) fp32, the anchor every row shares."""
    w = w_start.to(torch.float32, copy=True)
    for step in range(n_steps):
        xb, yb = agent_minibatch(x, y, step, batch)
        g = mlp.grad_stacked(spec, w, xb, yb)
        # in place: w is this function's own buffer (the JAX scan carry);
        # the anchor w_start is widened in the update, and the kernel forms
        # live = (step < active_steps) itself
        ops.dual_proximal_sgd(w, g, w_start, w_cloud, lr=hp.lr, mu1=hp.mu1,
                              mu2=hp.mu2, active_steps=active_steps,
                              step=step, out=w)
    return w


def _fed_arrays(cfg: SimConfig, hp: H2FedParams, fed: FederatedData,
                device):
    x_all = torch.from_numpy(fed.x).to(device)
    y_all = torch.from_numpy(fed.y).to(device=device, dtype=torch.long)
    n_per_agent = torch.from_numpy(
        np.asarray(fed.n_per_agent, np.float32)).to(device)
    rsu_assign = torch.from_numpy(fed.rsu_assign).to(device=device,
                                                     dtype=torch.long)
    spe = max(int(fed.x.shape[1]) // cfg.batch, 1)       # steps per epoch
    return x_all, y_all, n_per_agent, rsu_assign, spe, hp.local_epochs * spe


def _make_flat_round_body(cfg: SimConfig, hp: H2FedParams,
                          het: HeterogeneityModel, fed: FederatedData,
                          spec: FlatSpec, *, device, fused: bool = True,
                          ) -> Callable[..., FlatSimState]:
    """The global round: ``(state, draws=None) -> state``.

    The round advances the state's generator (the JAX round's input is
    donated; here only the training loop's own buffer is updated in
    place).  ``fused=True`` runs both
    aggregation layers through the fused aggregate-and-blend kernel;
    ``fused=False`` through the aggregation matmul and a separate blend.
    ``draws``, when given, holds ``hp.lar`` injected (mask, active_steps)
    pairs and replaces the round's own draws (the state's connectivity is
    then left as it was)."""
    x_all, y_all, n_per_agent, rsu_assign, spe, n_steps = _fed_arrays(
        cfg, hp, fed, device)

    def global_round(state: FlatSimState,
                     draws: Optional[Draws] = None) -> FlatSimState:
        if draws is not None and len(draws) != hp.lar:
            raise ValueError(f"want {hp.lar} injected draws, got {len(draws)}")
        # Alg. 2 l.2: RSUs replace w_k with the cloud model (materialised)
        rsu_flat = spec.to_storage(state.cloud_flat).expand(
            cfg.n_rsus, spec.n).clone()
        conn, agent_flat, masses = state.conn, state.agent_flat, []
        for i in range(hp.lar):
            if draws is None:
                conn, mask, active_steps = round_draws(
                    state.gen, conn, het, hp, cfg.n_agents, spe)
            else:
                mask, active_steps = (t.to(device) for t in draws[i])
            # Alg. 2 l.5 / Alg. 1 l.1: every agent starts from its RSU row
            w_start = rsu_flat.index_select(0, rsu_assign)       # (A, N)
            agent_flat = spec.to_storage(_local_train_flat(
                spec, x_all, y_all, w_start, state.cloud_flat, hp, n_steps,
                active_steps, cfg.batch))
            # Alg. 2 l.8: one (R, A) @ (A, N) pass over the fleet
            if fused:
                rsu_flat, mass = ops.agg_blend(agent_flat, n_per_agent, mask,
                                               rsu_assign, cfg.n_rsus,
                                               rsu_flat)
            else:
                new_rsu, mass = ops.masked_hier_agg(agent_flat, n_per_agent,
                                                    mask, rsu_assign,
                                                    cfg.n_rsus)
                rsu_flat = torch.where((mass > 0)[:, None], new_rsu,
                                       rsu_flat).to(rsu_flat.dtype)
            masses.append(mass)

        # Alg. 3 l.6: cloud aggregation, the (1, R) @ (R, N) pass
        total_mass = torch.stack(masses).sum(dim=0)              # (R,)
        if fused:
            cloud_flat = ops.cloud_blend(rsu_flat, total_mass,
                                         state.cloud_flat)
        else:
            new_cloud = ops.cloud_agg(rsu_flat, total_mass)
            cloud_flat = torch.where(total_mass.sum() > 0, new_cloud.float(),
                                     state.cloud_flat)
        return FlatSimState(agent_flat=agent_flat, rsu_flat=rsu_flat,
                            cloud_flat=cloud_flat, conn=conn, gen=state.gen)

    return global_round


def _run_sync(res, init_params: Params, *, device,
              eval_fn: Optional[Callable[[Params], float]] = None,
              draws: Optional[Sequence[Draws]] = None,
              ) -> Tuple[SimState, Dict[str, np.ndarray]]:
    """``run_scenario``'s flat target: run the scenario's rounds with the
    fleet resident in (A, N)/(R, N)/(N,) device buffers.  ``draws[r]``, when
    given, is round r's injected draws.  Only the (N,) cloud master is
    unraveled, for eval."""
    s = res.spec
    cfg, hp, het, fed = res.cfg, s.hp, s.het, res.fed
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
    round_fn = _make_flat_round_body(cfg, hp, het, fed, spec, device=device,
                                     fused=s.fused)
    accs, rounds = [], []
    for r in range(s.rounds):
        state = round_fn(state, None if draws is None else draws[r])
        if eval_fn is not None and (r % cfg.eval_every == 0
                                    or r == s.rounds - 1):
            accs.append(float(eval_fn(spec.unravel(state.cloud_flat))))
            rounds.append(r + 1)
    history = {"round": np.asarray(rounds), "acc": np.asarray(accs)}
    return from_flat_state(spec, state), history
