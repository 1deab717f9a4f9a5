"""The engine entry points: ``run_scenario`` runs one scenario through the
synchronous flat engine or the semi-async tick engine, with or without a
fault plan, resident or cohort-streamed (``fedsim/streaming``, for a spec
with ``fleet_store="host"`` or ``chunk_agents > 0``), or through the
event-driven serve loop (``fedsim/serving``, for ``serve_events > 0``);
``run_scenarios`` runs a whole grid of them as one batched program per
group, and a group of streamed or serve-mode scenarios one cell at a time
(``ScenarioSpec.validate`` refuses what is not ported).

The paper's figures are grids: CSR in {0.1..1.0}, mu1 / mu2 sweeps,
seed-averaged curves.  Scenarios whose ``ResolvedScenario.static_key`` is
equal (same shapes and engine flavour) stack on a leading scenario axis S:
an (S, A, N) fleet, (S, R, N) RSU buffers, (S, N) cloud masters and one
``torch.Generator`` a scenario.  The round body is the engines' own
(``simulator._make_flat_program``, ``async_engine._make_async_program``),
and every kernel call in it serves all S scenarios in one launch, so a
grid of S cells costs one launch a kernel call where S sequential runs
cost S.  The scalars that differ (mu1 / mu2 / lr as (S,) tensors the
update kernel reads by scenario; csr / fsr / scd / delay_p for each
scenario's own draws) ride in ``simulator.Lanes``; the cadence knobs
``lar`` / ``local_epochs`` / ``cloud_every`` may differ too: the loops run
to the group's bounds and each scenario stops at its own.  A group whose
scenarios share one ``FederatedData`` (one ``partition_key``, e.g. a seed
average or a mu sweep over one realization) keeps one copy of its data
block, not S.  Fault plans lower to per-round mask data stacked over the
scenarios, so a grid of different plans with one guard configuration runs
as one program.

Built programs are memoized in the ``core/program_cache`` registry, so a
later ``max_sweep`` chunk, a repeated grid or a singleton re-run builds
nothing.  On one rank the card holds the whole sweep; on several ranks
(``launch.mesh.run_ranks``) whose count divides S, ``sweep_mesh`` lays the
scenario axis over them, each runs its share of the cells, and the
histories are gathered at the end: the reference's ``_shard_sweep``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import program_cache
from repro_torch.core.flatten import spec_of
from repro_torch.core.heterogeneity import ConnState
from repro_torch.core.scenario import ResolvedScenario, ScenarioSpec
from repro_torch.device import resolve_device
from repro_torch.fedsim import (async_engine, serving, sharded, simulator,
                                streaming)
from repro_torch.fedsim.async_engine import async_config  # noqa: F401
from repro_torch.launch import collectives
from repro_torch.launch.mesh import FleetMesh, world
from repro_torch.models import mlp
from repro_torch.models.mlp import Params

# the per-scenario scalars a sweep may batch; every other field is program
# structure and equal across a group (its static_key)
DYN_HP = ("mu1", "mu2", "lr")
DYN_HET = ("csr", "fsr", "scd", "delay_p")
# cadence knobs batched under the group's bounds (hp.* and spec.* fields)
DYN_CADENCE = ("lar", "local_epochs")
DYN_SPEC = ("cloud_every",)

# engines whose round body takes the scenario axis
SWEEPABLE = ("flat", "async")


def default_params(s: ScenarioSpec, device) -> Params:
    """The paper's MLP (``hidden_dims`` overriding its widths) drawn from a
    generator seeded with the spec's data seed, on ``device``."""
    from repro_torch.configs.mnist_mlp import CONFIG
    cfg_model = (CONFIG if not s.hidden_dims else dataclasses.replace(
        CONFIG, hidden_dims=tuple(s.hidden_dims)))
    return mlp.init_params(cfg_model, torch.Generator().manual_seed(s.seed),
                           device=device)


def run_scenario(res, init_params: Optional[Params] = None, *, device=None,
                 eval_fn: Optional[Callable[[Params], float]] = None,
                 draws: Optional[Sequence] = None, mesh=None, topo=None):
    """Run ONE scenario through its engine; returns ``(final state,
    history)``.  History holds ``round`` and ``acc``; the async engine adds
    per-round ``absorbed_mass`` and ``pending_mass``; a fault plan adds
    ``quarantined`` (and, async, ``blocked_mass``).

    ``engine="sharded"`` runs ``fedsim/sharded`` over ``mesh`` (a
    ``launch.mesh.FleetMesh`` or a built ``core.topology.HierarchyTopology``;
    by default ``make_fleet_mesh`` over the running ranks with the spec's
    ``model_shards``); ``engine="async"`` with ``topo`` (an rsu_sharded
    topology) or ``rsu_sharded=True`` runs the rsu-sharded tick loop.  On
    more than one rank every rank calls this with the same arguments
    (``launch.mesh.run_ranks``) and gets the same result.

    ``device`` is ``cuda`` when None (raises without a GPU); the tests pass
    ``device="cpu"``, which runs the kernels' plain versions.
    ``init_params`` defaults to the paper's MLP drawn from a generator
    seeded with the spec's data seed.  ``draws[r]`` injects round r's
    draws in place of the engine's own (the parity seam): a (mask,
    active_steps) pair per local round for ``flat``, a (mask, active_steps,
    delays) triple per tick for ``async``, a (mask, active_steps) pair
    per global tick for a serve-mode spec (``draws[t]``).  ``eval_fn``
    overrides the test-set accuracy eval.  A streamed spec returns the
    streamed round's state (``fedsim/streaming``); a serve-mode spec
    (``serve_events > 0``) runs the event-driven loop (``fedsim/serving``)
    and adds its stats summary as ``history["serve"]``."""
    dev = resolve_device(device)
    if isinstance(res, ScenarioSpec):
        res = res.resolve()
    s = res.spec.validate()
    if init_params is None:
        init_params = default_params(s, dev)
    kw = {}
    if s.serve_events:
        run = serving._run_serve
    elif s.engine == "sharded":
        run, kw = sharded._run_sharded, {"mesh": mesh}
    elif s.fleet_store != "device" or s.chunk_agents:
        run = streaming._run_streamed
    elif s.engine == "async":
        run, kw = async_engine._run_async, {"mesh": mesh, "topo": topo}
    else:
        run = simulator._run_sync
    return run(res, init_params, device=dev, eval_fn=eval_fn, draws=draws,
               **kw)


# --------------------------------------------------------------------------
# grouping
# --------------------------------------------------------------------------

def group_indices(resolved: Sequence[ResolvedScenario]) -> List[List[int]]:
    """Scenario indices in groups of equal ``static_key``, each group and
    its members in first-seen order."""
    groups: Dict[tuple, List[int]] = {}
    for i, r in enumerate(resolved):
        groups.setdefault(r.static_key, []).append(i)
    return list(groups.values())


def _stack_or_share(arrays: Sequence, to_tensor: Callable):
    """(the one tensor, None) when every scenario holds the same array
    object: a block the group shares, one copy whatever S is; else (the
    stacked (S, ...) tensor, 0)."""
    first = arrays[0]
    if all(a is first for a in arrays):
        return to_tensor(first), None
    return torch.stack([to_tensor(a) for a in arrays]), 0


def _dyn_scalars(specs: Sequence[ScenarioSpec],
                 force: Sequence[str] = ()) -> Dict[str, tuple]:
    """The per-scenario scalars a group batches: the fields that differ
    across ``specs``, plus ``force``'s (``run_scenarios`` passes the whole
    group's varying set, so every ``max_sweep`` chunk of a group, a
    constant tail chunk included, has one program).  Name -> the S
    values."""
    force = set(force)
    dyn: Dict[str, tuple] = {}

    def _add(key, vals):
        if key in force or any(v != vals[0] for v in vals[1:]):
            dyn[key] = tuple(vals)

    for name in DYN_HP + DYN_CADENCE:
        _add(f"hp.{name}", [getattr(s.hp, name) for s in specs])
    for name in DYN_HET:
        _add(f"het.{name}", [getattr(s.het, name) for s in specs])
    for name in DYN_SPEC:
        _add(f"spec.{name}", [getattr(s, name) for s in specs])
    return dyn


def _stack_fault_rounds(group: Sequence[ResolvedScenario],
                        lar_bound: int) -> Dict[str, np.ndarray]:
    """Each scenario's lowered fault schedule, stacked over the scenarios:
    (S, rounds, lar_bound, A|R) float32 host arrays.  A plan lowers over
    its own tick clock (rounds x its lar); rows past a scenario's lar (a
    padded group) repeat its round's last tick, and the engines never use
    them (that scenario's tick or local round does not happen)."""
    out: Dict[str, list] = {k: [] for k in faults_mod.FAULT_FIELDS}
    for r in group:
        s = r.spec
        lar = s.hp.lar
        sched = s.faults.validate(s.n_rsus).lower(
            s.n_agents, s.n_rsus, s.rounds * lar)
        pad = np.minimum(np.arange(lar_bound), lar - 1)          # (L,)
        idx = np.minimum(np.arange(s.rounds)[:, None] * lar + pad[None, :],
                         sched.n_ticks - 1)                      # (rounds, L)
        for k in faults_mod.FAULT_FIELDS:
            out[k].append(getattr(sched, k)[idx])
    return {k: np.stack(v) for k, v in out.items()}


def _cadence_bounds(specs: Sequence[ScenarioSpec],
                    dyn_names: Sequence[str]
                    ) -> Optional[simulator.Cadence]:
    """The group's loop bounds when a cadence knob is batched; None keeps
    the scenarios' own (equal) cadence."""
    if not any(f"hp.{n}" in dyn_names for n in DYN_CADENCE):
        return None
    return simulator.Cadence(
        lar=max(s.hp.lar for s in specs),
        local_epochs=max(s.hp.local_epochs for s in specs))


def _baked_scalars(s0: ScenarioSpec, dyn_names) -> tuple:
    """The sweepable scalars a program takes as the group's one value (not
    batched): part of its registry key."""
    baked = []
    for name in DYN_HP + DYN_CADENCE:
        if f"hp.{name}" not in dyn_names:
            baked.append((f"hp.{name}", getattr(s0.hp, name)))
    for name in DYN_HET:
        if f"het.{name}" not in dyn_names:
            baked.append((f"het.{name}", getattr(s0.het, name)))
    for name in DYN_SPEC:
        if f"spec.{name}" not in dyn_names:
            baked.append((f"spec.{name}", getattr(s0, name)))
    return tuple(baked)


def sweep_mesh(n_scenarios: int):
    """The layout of a sweep: a ('sweep',) mesh over the running ranks when
    there are more than one and they divide the S scenarios evenly (each
    rank runs its S / n cells: pure data parallelism, no collective in the
    rounds); ``None`` otherwise, the whole scenario axis on this rank.
    Every rank must call it together (the mesh's groups are built
    collectively)."""
    n = world()[1]
    if n <= 1 or n_scenarios % n:
        return None
    return FleetMesh((n,), ("sweep",))


# --------------------------------------------------------------------------
# the batched program
# --------------------------------------------------------------------------

class SweepProgram(NamedTuple):
    """One built sweep: ``round_fn(state, draws=None, fault_r=None)``
    advances every scenario one global round and returns the state (flat),
    or ``(state, metrics)`` (async, or with a fault plan); ``fault_r`` is
    round r's slice of ``fault_rounds`` on the device."""
    round_fn: Callable
    state: Any                # FlatSweepState | AsyncSweepState
    data: simulator.FleetData
    lanes: simulator.Lanes
    dyn: Dict[str, tuple]     # the batched scalars, name -> S values
    eval_fn: Callable         # cloud (S, N) -> (S,) accuracies
    engine: str
    fspec: Any
    n_scenarios: int
    # (S, rounds, lar_bound, A|R) lowered fault masks (host numpy), or
    # None for a fault-free group
    fault_rounds: Optional[Dict[str, np.ndarray]] = None


def build_sweep(group: Sequence[ResolvedScenario], init_params, *,
                device=None, force_dyn: Sequence[str] = (),
                cadence: Optional[simulator.Cadence] = None,
                mesh=None) -> SweepProgram:
    """Stack a group of equal ``static_key`` into one batched round program
    on ``device`` (``cuda`` when None).

    ``init_params``: one parameter dict every scenario starts from, or one
    a scenario.  ``force_dyn`` / ``cadence`` let ``run_scenarios`` pin the
    batched fields and the loop bounds group-wide, so every ``max_sweep``
    chunk of a group is the same program.  With ``program_cache=True`` (the
    spec's default) the round program and the batched eval are memoized
    under a ``ProgramKey``; ``mesh`` is the sweep mesh the group's cells
    were laid over (``sweep_mesh``), part of that key."""
    dev = resolve_device(device)
    specs = [r.spec for r in group]
    s0, cfg = specs[0], group[0].cfg
    S, A, R = len(group), s0.n_agents, s0.n_rsus
    engine = s0.engine
    if engine not in SWEEPABLE:
        raise ValueError(f"engine {engine!r} is not sweepable "
                         f"(want one of {SWEEPABLE})")
    if s0.serve_events:
        raise ValueError("serve-mode scenarios (serve_events > 0) are "
                         "event-driven and cannot be stacked into a sweep; "
                         "run them through run_scenario")
    if any(r.static_key != group[0].static_key for r in group[1:]):
        raise ValueError("a sweep group's scenarios must share static_key")

    params_list = (list(init_params) if isinstance(init_params, (list, tuple))
                   else [init_params] * S)
    if len(params_list) != S:
        raise ValueError(f"init_params list must have one entry per "
                         f"scenario ({S}), got {len(params_list)}")
    fspec = spec_of(params_list[0], storage_dtype=s0.fleet_dtype)

    def ravel(p):
        return fspec.ravel({k: v.to(dev) for k, v in p.items()})
    if all(p is params_list[0] for p in params_list):
        vecs = ravel(params_list[0]).expand(S, fspec.n)
    else:
        vecs = torch.stack([ravel(p) for p in params_list])

    # data blocks: one copy when the group shares one FederatedData
    # realization (the same array objects), stacked otherwise
    feds = [r.fed for r in group]
    blocks, data_axes = {}, {}
    for name in simulator.FLEET_BLOCKS:
        blocks[name], data_axes[name] = _stack_or_share(
            [getattr(f, name) for f in feds],
            lambda a, name=name: simulator.block_tensor(name, a, dev))
    data = simulator.FleetData(**blocks,
                               spe=max(int(feds[0].x.shape[1]) // s0.batch,
                                       1))
    dyn = _dyn_scalars(specs, force=force_dyn)
    if cadence is None:
        cadence = _cadence_bounds(specs, dyn)
    lanes = simulator.Lanes.of(
        [s.hp for s in specs], [s.het for s in specs],
        batched=[n for n in simulator.TRAIN_SCALARS if f"hp.{n}" in dyn],
        cloud_every=[s.cloud_every for s in specs], device=dev)

    # a fault plan's guard configuration is in static_key, so the group is
    # all faulted or all clean with one guard; the schedules are data
    plan0 = s0.faults
    fault_rounds = None
    if plan0 is not None:
        fault_rounds = _stack_fault_rounds(
            group, cadence.lar if cadence is not None else s0.hp.lar)

    x_t, ax_x = _stack_or_share(
        [r.test.x for r in group], lambda a: torch.from_numpy(a).to(dev))
    y_t, ax_y = _stack_or_share(
        [r.test.y for r in group],
        lambda a: torch.from_numpy(a).to(device=dev, dtype=torch.long))

    def _build_programs():
        program_cache.note_trace("sweep_round")
        if engine == "flat":
            program = simulator._make_flat_program(
                cfg, fspec, fused=s0.fused, cadence=cadence, faults=plan0)
        else:
            program = async_engine._make_async_program(
                cfg, fspec, async_config(s0).validate(), fused=s0.fused,
                cadence=cadence, faults=plan0)

        def eval_core(cloud, x, y):
            return mlp.accuracy_stacked(fspec.unravel_stacked(cloud), x, y)
        return program, eval_core

    prog_key = program_cache.ProgramKey(
        kind="sweep",
        static_key=group[0].static_key,
        n_scenarios=S,
        dyn_names=tuple(sorted(dyn)),
        baked=(_baked_scalars(s0, dyn),),
        cadence=cadence,
        data_axes=(tuple(sorted(data_axes.items())), ax_x, ax_y),
        donation=(),
        devices=program_cache.device_fingerprint(dev),
        mesh=program_cache.mesh_fingerprint(mesh),
        flags=program_cache.ops_flags(s0.fused))
    program, eval_core = program_cache.get_or_build(
        prog_key, _build_programs, enabled=s0.program_cache)

    sv = fspec.to_storage(vecs)
    gens = []
    for r in group:
        gen = torch.Generator(device=dev)
        gen.manual_seed(r.cfg.seed)
        gens.append(gen)
    common = dict(
        agent_flat=sv[:, None].expand(S, A, fspec.n).clone(),
        rsu_flat=sv[:, None].expand(S, R, fspec.n).clone(),
        cloud_flat=vecs.clone(),
        conn=ConnState(torch.zeros((S, A), dtype=torch.int32, device=dev)),
        gens=tuple(gens))
    if engine == "flat":
        state: Any = simulator.FlatSweepState(**common)
    else:
        state = async_engine.AsyncSweepState(
            **common,
            rsu_mass=torch.zeros((S, R), device=dev),
            pending_x=torch.zeros((S, A, fspec.n), dtype=fspec.storage_dtype,
                                  device=dev),
            pending_w=torch.zeros((S, A), device=dev),
            pending_t=torch.zeros((S, A), dtype=torch.int32, device=dev),
            cloud_macc=torch.zeros((S, R), device=dev),
            ticks=(0,) * S)

    def round_fn(state, draws=None, fault_r=None):
        return program(state, data, lanes, draws, fault_r)

    return SweepProgram(round_fn=round_fn, state=state, data=data,
                        lanes=lanes, dyn=dyn,
                        eval_fn=lambda cloud: eval_core(cloud, x_t, y_t),
                        engine=engine, fspec=fspec, n_scenarios=S,
                        fault_rounds=fault_rounds)


def run_sweep(group: Sequence[ResolvedScenario], init_params, *,
              device=None, force_dyn: Sequence[str] = (),
              cadence: Optional[simulator.Cadence] = None,
              draws: Optional[Sequence] = None,
              ) -> List[Dict[str, np.ndarray]]:
    """Run one group of equal ``static_key`` as a single batched program;
    returns one history a scenario (``run_scenario``'s schema: ``round``,
    ``acc``; async ``absorbed_mass`` and ``pending_mass``; faulted
    ``quarantined``, and async ``blocked_mass``).  ``draws[r][s]`` injects
    scenario s's round-r draws (the parity seam).

    On more than one rank (``sweep_mesh``) each rank runs its contiguous
    S / n cells as one program, with the batched fields and the cadence
    bounds pinned over the whole group, and the histories are gathered:
    every rank returns all S, in order."""
    mesh = sweep_mesh(len(group))
    if mesh is None:
        return _run_sweep_here(group, init_params, device=device,
                               force_dyn=force_dyn, cadence=cadence,
                               draws=draws)
    specs = [r.spec for r in group]
    force_dyn = tuple(sorted(_dyn_scalars(specs, force=force_dyn)))
    if cadence is None:
        cadence = _cadence_bounds(specs, force_dyn)
    k = len(group) // mesh.size
    cells = slice(mesh.coordinate("sweep") * k,
                  (mesh.coordinate("sweep") + 1) * k)
    params = (list(init_params)[cells]
              if isinstance(init_params, (list, tuple)) else init_params)
    mine = _run_sweep_here(
        group[cells], params, device=device, force_dyn=force_dyn,
        cadence=cadence, mesh=mesh,
        draws=None if draws is None else [d[cells] for d in draws])
    parts = collectives.all_gather_objects(mine, mesh, "sweep",
                                           where="gather")
    return [h for part in parts for h in part]


def _run_sweep_here(group: Sequence[ResolvedScenario], init_params, *,
                    device, force_dyn: Sequence[str],
                    cadence: Optional[simulator.Cadence], draws,
                    mesh=None) -> List[Dict[str, np.ndarray]]:
    """``run_sweep`` on this rank: the group's cells as one program."""
    prog = build_sweep(group, init_params, device=device,
                       force_dyn=force_dyn, cadence=cadence, mesh=mesh)
    s0 = group[0].spec
    dev = prog.state.cloud_flat.device
    state = prog.state
    faulted = prog.fault_rounds is not None
    accs, rounds = [], []
    hist: Dict[str, list] = {"absorbed_mass": [], "pending_mass": [],
                             "quarantined": [], "blocked_mass": []}
    for r in range(s0.rounds):
        fault_r = None
        if faulted:
            fault_r = {k: torch.from_numpy(np.ascontiguousarray(v[:, r]))
                       .to(dev) for k, v in prog.fault_rounds.items()}
        out = prog.round_fn(state, None if draws is None else draws[r],
                            fault_r)
        if prog.engine == "async":
            state, metrics = out
            hist["absorbed_mass"].append(
                metrics["absorbed_mass"].sum(dim=(1, 2)))
            hist["pending_mass"].append(metrics["pending_mass"])
            if faulted:
                hist["quarantined"].append(metrics["quarantined"].sum(1))
                hist["blocked_mass"].append(metrics["blocked_mass"].sum(1))
        elif faulted:
            state, metrics = out
            hist["quarantined"].append(metrics["quarantined"])
        else:
            state = out
        if r % s0.eval_every == 0 or r == s0.rounds - 1:
            accs.append(prog.eval_fn(state.cloud_flat))
            rounds.append(r + 1)
    # one transfer to the host for the whole run
    acc_mat = torch.stack(accs, dim=1).cpu().numpy()            # (S, T)
    cols = {k: torch.stack(v, dim=1).cpu().numpy()
            for k, v in hist.items() if v}
    out_h = []
    for i in range(prog.n_scenarios):
        h = {"round": np.asarray(rounds), "acc": acc_mat[i]}
        h.update({k: v[i] for k, v in cols.items()})
        out_h.append(h)
    return out_h


def run_scenarios(specs_or_resolved: Sequence, init_params, *,
                  device=None, max_sweep: int = 0
                  ) -> List[Dict[str, np.ndarray]]:
    """Run a whole grid: group by ``static_key`` and run each group as one
    batched program; returns the histories in input order.

    A group of one runs through the (cached) one-cell program, so a lone
    spec re-run builds nothing; a group of sharded, rsu-sharded async,
    streamed or serve-mode scenarios runs one cell at a time through
    ``run_scenario``.
    ``init_params``: one shared parameter dict, one a scenario, or a
    callable ``spec -> params`` (e.g. the per-dataset pretrained model).
    ``max_sweep`` > 0 cuts
    larger groups into chunks of that many scenarios (the sweep state is S
    times one scenario's fleet); a short tail chunk is filled up with
    copies of its last cell (their histories dropped), and the batched
    fields and the cadence bounds are pinned group-wide, so every chunk of
    a group runs the same program."""
    resolved = [s.resolve() if isinstance(s, ScenarioSpec) else s
                for s in specs_or_resolved]
    if callable(init_params):
        params_list = [init_params(r.spec) for r in resolved]
    elif isinstance(init_params, (list, tuple)):
        params_list = list(init_params)
    else:
        params_list = [init_params] * len(resolved)
    if len(params_list) != len(resolved):
        raise ValueError("need one init_params per scenario")

    out: List[Optional[Dict[str, np.ndarray]]] = [None] * len(resolved)
    for idx in group_indices(resolved):
        s0 = resolved[idx[0]].spec
        if (s0.engine not in SWEEPABLE or s0.rsu_sharded
                or s0.fleet_store != "device" or s0.chunk_agents
                or s0.serve_events):
            # the sharded, streamed and serve engines take no scenario
            # axis: one cell at a time
            for i in idx:
                out[i] = run_scenario(resolved[i], params_list[i],
                                      device=device)[1]
            continue
        group_specs = [resolved[i].spec for i in idx]
        force_dyn = tuple(sorted(_dyn_scalars(group_specs)))
        cadence = _cadence_bounds(group_specs, force_dyn)
        chunks = ([idx] if not max_sweep else
                  [idx[i:i + max_sweep]
                   for i in range(0, len(idx), max_sweep)])
        for chunk in chunks:
            pad = (max_sweep - len(chunk)
                   if max_sweep and len(idx) > max_sweep else 0)
            cidx = list(chunk) + [chunk[-1]] * pad
            hists = run_sweep([resolved[i] for i in cidx],
                              [params_list[i] for i in cidx], device=device,
                              force_dyn=force_dyn, cadence=cadence)
            for i, h in zip(chunk, hists):
                out[i] = h
    return out
