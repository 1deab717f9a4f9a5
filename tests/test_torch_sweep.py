"""The port's multi-scenario sweep (``fedsim/sweep.run_scenarios``) against
the JAX package's, and against the port's own sequential runs, on the CPU.

A sweep stacks S scenarios on a leading axis and runs them as one batched
program.  Held here:

* against the reference: the JAX package's sweep on the same grid, its
  per-scenario draws (the sequential key discipline, which its sweep
  keeps) injected into the port's sweep through the draws seam; both start
  from the same weights and the same numpy-built data;
* within the port: each scenario of a sweep equals its own sequential
  ``run_scenario`` (its generator stream is the same), mixed cadence and
  fault grids are one program build, a shared data block is not copied S
  times, and ``max_sweep`` chunks and singletons reuse the built program.

Tolerances: fp32 buffers 1e-5 absolute / relative against the reference
(the packages sum gradients and aggregations in different orders);
accuracy histories 2e-3 (one of 100 test samples is 1e-2, so this holds
the histories equal); bf16 buffers one bf16 ulp of the stored value
(2**-7 relative plus 2**-9 absolute), each tick from the reference's state
(ROADMAP.md, queue 3: a one-ulp difference of a stored row can flip a
hidden ReLU unit of an agent that trains from it on the next tick).
Within the port, sweep against sequential: 1e-6 on the buffers (the same
arithmetic, batched matmuls against single ones), histories equal.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs.mnist_mlp import CONFIG as JCONFIG
from repro.core.faults import FaultPlan as JPlan
from repro.core.h2fed import H2FedParams as JHP
from repro.core.heterogeneity import HeterogeneityModel as JHet
from repro.core.heterogeneity import init_conn_state as j_init_conn
from repro.core.heterogeneity import sample_latency as j_sample_latency
from repro.core.scenario import ScenarioSpec as JSpec
from repro.fedsim import async_engine as jae
from repro.fedsim import simulator as jsim
from repro.fedsim import sweep as jsweep
from repro.kernels import masked_hier_agg as jmha
from repro.kernels import ops as jops
from repro.models import mlp as jmlp

from repro_torch import convert
from repro_torch.core import program_cache
from repro_torch.core.faults import (ChurnWindow, CorruptSpec, FaultPlan,
                                     RsuOutage)
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.heterogeneity import HeterogeneityModel
from repro_torch.core.scenario import ScenarioSpec as TSpec
from repro_torch.fedsim import async_engine as tae
from repro_torch.fedsim import run_scenarios
from repro_torch.fedsim import simulator as tsim
from repro_torch.fedsim import sweep as tsweep
from repro_torch.fedsim.sweep import run_scenario

BASE = dict(n_agents=8, n_rsus=2, batch=16, n_train=400, n_test=100,
            rounds=2)
HP = dict(mu1=0.01, mu2=0.005, lar=2, local_epochs=1, lr=0.1)
HET = dict(csr=0.8, scd=1)
ASYNC = dict(staleness_decay=0.6, buffer_keep=0.25)
F32 = dict(rtol=1e-5, atol=1e-5)
SAME = dict(rtol=1e-6, atol=1e-6)
FLAT_FIELDS = ("agent_flat", "rsu_flat", "cloud_flat")
ASYNC_FIELDS = FLAT_FIELDS + ("rsu_mass", "pending_x", "pending_w",
                              "cloud_macc")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread: the tensors are small, and torch's pool
    threads would otherwise compete with JAX's for the cores when test
    files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jparams = jmlp.init_params(JCONFIG, jax.random.key(7))
    return jparams, convert.params_from_jax({k: np.asarray(v)
                                             for k, v in jparams.items()})


def specs_pair(cells, **common):
    """One (JAX, port) ScenarioSpec pair a cell: ``cells`` are dicts with
    optional ``hp`` / ``het`` overrides and any other spec field."""
    out = []
    for cell in cells:
        cell = dict(cell)
        hp = dict(HP, **cell.pop("hp", {}))
        het = dict(HET, **cell.pop("het", {}))
        kw = dict(BASE, **common, **cell)
        plan = kw.pop("faults", None)
        out.append((
            JSpec(**kw, hp=JHP(**hp), het=JHet(**het),
                  faults=None if plan is None else
                  JPlan.from_dict(plan.to_dict())),
            TSpec(**kw, hp=H2FedParams(**hp), het=HeterogeneityModel(**het),
                  faults=plan)))
    return [j for j, _ in out], [t for _, t in out]


def reference_draws(jres, n_rounds, latency):
    """Each scenario's draws in the reference's key discipline (its sweep
    keeps the sequential one), as torch tensors: draws[round][scenario] =
    one (mask, active_steps[, delays]) tuple a local round (tick)."""
    per = []
    for r in jres:
        cfg, hp, het = r.cfg, r.spec.hp, r.spec.het
        spe = max(r.fed.x.shape[1] // cfg.batch, 1)
        rng, conn, rounds = jax.random.key(cfg.seed), j_init_conn(
            cfg.n_agents), []
        for _ in range(n_rounds):
            rng, k_rounds = jax.random.split(rng)
            keys = jsim.round_keys(k_rounds, hp.lar)
            rd = []
            for i in range(hp.lar):
                conn, mask, act = jsim.round_draws(keys[i], conn, het, hp,
                                                   cfg.n_agents, spe)
                t = (mask, act)
                if latency:
                    t += (j_sample_latency(
                        jax.random.fold_in(keys[i], jae._LATENCY_FOLD),
                        cfg.n_agents, het),)
                rd.append(tuple(torch.from_numpy(np.array(x)) for x in t))
            rounds.append(rd)
        per.append(rounds)
    return [[per[s][r] for s in range(len(jres))] for r in range(n_rounds)]


def reference_sweep(jres, jparams):
    """The JAX sweep's final state and histories."""
    prog = jsweep.build_sweep(jres, jparams)
    state = prog.state
    for _ in range(jres[0].spec.rounds):
        out = prog.round_fn(state, prog.data, prog.dyn)
        state = out[0] if type(out) is tuple else out
    return state, jsweep.run_sweep(jres, jparams)


def port_sweep(tres, tparams, draws=None):
    """The port's sweep (``build_sweep`` and its round function) from
    ``tres``: final state; its histories come from ``run_sweep``."""
    prog = tsweep.build_sweep(tres, tparams, device="cpu")
    state = prog.state
    for r in range(tres[0].spec.rounds):
        fault_r = None if prog.fault_rounds is None else {
            k: torch.from_numpy(np.ascontiguousarray(v[:, r]))
            for k, v in prog.fault_rounds.items()}
        out = prog.round_fn(state, None if draws is None else draws[r],
                            fault_r)
        state = out[0] if type(out) is tuple else out
    return prog, state


def assert_state_close(state, want, fields, tol):
    for name in fields:
        got = getattr(state, name)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(getattr(want, name), np.float32),
            err_msg=name, **tol)


def assert_hist_close(got, want, keys=("acc",)):
    np.testing.assert_array_equal(got["round"], want["round"])
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=2e-3, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("engine", ["flat", "async"])
def test_grid_matches_reference(params, engine):
    """A Fig. 2-shaped grid (csr and mu1 differ; async also delay_p, with
    latencies, staleness decay, buffer keep and a decoupled cloud cadence
    live), one batched program in each package."""
    jparams, tparams = params
    cells = [dict(het=dict(csr=c), hp=dict(mu1=m), sim_seed=i)
             for i, (c, m) in enumerate(((1.0, 0.0), (0.5, 0.01),
                                         (0.3, 0.004)))]
    common = {}
    if engine == "async":
        common = dict(engine="async", cloud_every=2, **ASYNC)
        for cell, p in zip(cells, (0.0, 0.5, 0.8)):
            cell["het"].update(max_delay=2, delay_p=p)
            cell["hp"]["lar"] = 3
    jspecs, tspecs = specs_pair(cells, **common)
    jres = [s.resolve() for s in jspecs]
    tres = [s.resolve() for s in tspecs]
    assert len(jsweep.group_indices(jres)) == 1
    assert tsweep.group_indices(tres) == [[0, 1, 2]]
    jstate, jhists = reference_sweep(jres, jparams)
    draws = reference_draws(jres, BASE["rounds"], engine == "async")
    prog, state = port_sweep(tres, tparams, draws)
    assert sorted(prog.dyn) == sorted(jsweep._dyn_scalars(jspecs))
    fields = ASYNC_FIELDS if engine == "async" else FLAT_FIELDS
    assert_state_close(state, jstate, fields, F32)
    hists = tsweep.run_sweep(tres, tparams, device="cpu", draws=draws)
    keys = ("acc",) + (("absorbed_mass", "pending_mass")
                       if engine == "async" else ())
    for got, want in zip(hists, jhists):
        assert_hist_close(got, want, keys)
    if engine == "async":
        assert state.ticks == tuple(int(t) for t in jstate.tick)
        np.testing.assert_array_equal(state.pending_t.numpy(),
                                      np.asarray(jstate.pending_t))


def test_async_bf16_tick_by_tick_matches_reference(params, monkeypatch):
    """A bf16 fleet: each one-tick round of the port's sweep from the
    reference sweep's state, the reference's aggregation entries on its
    Pallas kernels in interpret mode (which keep W in fp32, as the port
    does)."""
    for name in ("agg_absorb", "cloud_blend"):
        kernel = getattr(jmha, name)
        monkeypatch.setattr(jops, name, lambda *a, _k=kernel, **kw: _k(
            *a, interpret=True, **kw))
    jparams, tparams = params
    cells = [dict(het=dict(csr=c, max_delay=2, delay_p=0.6),
                  hp=dict(mu1=m, lar=1), sim_seed=i)
             for i, (c, m) in enumerate(((0.9, 0.0), (0.6, 0.02)))]
    jspecs, tspecs = specs_pair(cells, engine="async", fleet_dtype="bfloat16",
                                rounds=3, cloud_every=2, **ASYNC)
    jres = [s.resolve() for s in jspecs]
    tres = [s.resolve() for s in tspecs]
    jprog = jsweep.build_sweep(jres, jparams)
    tprog = tsweep.build_sweep(tres, tparams, device="cpu")
    draws = reference_draws(jres, 3, latency=True)
    jstate, state = jprog.state, tprog.state
    for r in range(3):
        if r:
            state = state._replace(ticks=tuple(int(t) for t in jstate.tick),
                                   **{f: convert.tensor_from_numpy(
                                       np.asarray(getattr(jstate, f)))
                                      for f in ASYNC_FIELDS + ("pending_t",)})
        jstate, _ = jprog.round_fn(jstate, jprog.data, jprog.dyn)
        state, _ = tprog.round_fn(state, draws[r])
        assert state.agent_flat.dtype == torch.bfloat16
        assert_state_close(state, jstate, ("agent_flat", "rsu_flat",
                                           "pending_x", "cloud_flat"),
                           dict(rtol=2 ** -7, atol=2 ** -9))
        assert_state_close(state, jstate, ("rsu_mass", "pending_w",
                                           "cloud_macc"), F32)


def _sequential_state(spec, tparams):
    """``run_scenario``'s final buffers as a one-scenario sweep lane."""
    final, hist = run_scenario(spec, tparams, device="cpu")
    if spec.engine == "async":
        return final, hist
    fspec = tsim.spec_of(tparams, storage_dtype=spec.fleet_dtype)
    return tsim.FlatSimState(
        agent_flat=fspec.ravel_stacked(final.agent_params).to(
            fspec.storage_dtype),
        rsu_flat=fspec.ravel_stacked(final.rsu_params).to(
            fspec.storage_dtype),
        cloud_flat=fspec.ravel(final.cloud_params), conn=final.conn,
        gen=final.gen), hist


def assert_matches_sequential(tspecs, tparams, prog, state, hists):
    lane = tae.lane_state if prog.engine == "async" else tsim.lane_state
    fields = ASYNC_FIELDS if prog.engine == "async" else FLAT_FIELDS
    for s, (spec, hist) in enumerate(zip(tspecs, hists)):
        want, want_h = _sequential_state(spec, tparams)
        assert_state_close(lane(state, s), want, fields, SAME)
        assert set(hist) == set(want_h)
        for k in hist:
            np.testing.assert_array_equal(hist[k], want_h[k], err_msg=k)
        if prog.engine == "async":
            assert lane(state, s).tick == want.tick


@pytest.mark.parametrize("engine", ["flat", "async"])
def test_mixed_cadence_is_one_build_and_each_scenario_its_sequential_run(
        params, engine):
    """lar in {2, 3}, local_epochs in {1, 2} (async also cloud_every in {0,
    3}) in one group: one program build, and each scenario of the sweep
    equals its own sequential run (a scenario past its lar draws nothing
    and keeps its state)."""
    _, tparams = params
    cadences = ((2, 1, 0), (3, 2, 3), (2, 2, 3), (3, 1, 0))
    cells = [dict(hp=dict(lar=lar, local_epochs=e, mu1=0.01 * i),
                  het=dict(csr=0.7), sim_seed=i)
             for i, (lar, e, _) in enumerate(cadences)]
    common = {}
    if engine == "async":
        common = dict(engine="async", **ASYNC)
        for cell, (_, _, ce) in zip(cells, cadences):
            cell["cloud_every"] = ce
            cell["het"].update(max_delay=2, delay_p=0.5)
    _, tspecs = specs_pair(cells, **common)
    tres = [s.resolve() for s in tspecs]
    program_cache.clear()
    hists = run_scenarios(tres, tparams, device="cpu")
    assert program_cache.trace_count("sweep_round") == 1
    prog, state = port_sweep(tres, tparams)
    assert program_cache.trace_count("sweep_round") == 1     # a hit
    assert prog.n_scenarios == 4
    assert {"hp.lar", "hp.local_epochs"} <= set(prog.dyn)
    assert_matches_sequential(tspecs, tparams, prog, state, hists)


def fault_plans():
    """Two different schedules under one guard (same norm clip)."""
    return (FaultPlan(churn=(ChurnWindow(frac=0.25, start=1, stop=3),),
                      corrupt=(CorruptSpec(kind="nan", frac=0.3),),
                      norm_clip=50.0, seed=1),
            FaultPlan(outages=(RsuOutage(rsu=1, start=1, stop=3),),
                      corrupt=(CorruptSpec(kind="scale", frac=0.3,
                                           scale=1e4),
                               CorruptSpec(kind="stale", frac=0.2)),
                      norm_clip=50.0, seed=2))


@pytest.mark.parametrize("engine", ["flat", "async"])
def test_fault_grid_is_one_program(params, engine):
    """Different fault plans with one guard configuration: one group, one
    program build, each scenario equal to its sequential run (quarantines,
    blocked mass and buffers)."""
    _, tparams = params
    cells = [dict(faults=p, sim_seed=i, hp=dict(lar=3))
             for i, p in enumerate(fault_plans())]
    common = dict(engine="async", cloud_every=0, **ASYNC) \
        if engine == "async" else {}
    _, tspecs = specs_pair(cells, **common)
    tres = [s.resolve() for s in tspecs]
    assert tsweep.group_indices(tres) == [[0, 1]]
    program_cache.clear()
    hists = run_scenarios(tres, tparams, device="cpu")
    assert program_cache.trace_count("sweep_round") == 1
    assert all(h["quarantined"].sum() > 0 for h in hists)
    if engine == "async":
        assert hists[1]["blocked_mass"].sum() > 0
    prog, state = port_sweep(tres, tparams)
    assert prog.fault_rounds["agent_up"].shape == (2, 2, 3, 8)
    assert_matches_sequential(tspecs, tparams, prog, state, hists)


def test_seed_average_shares_one_data_block(params):
    """Scenarios of one partition share its FederatedData: the sweep keeps
    one (A, n, D) data block on the device, not an S-times stacked copy,
    and batches nothing."""
    _, tparams = params
    _, tspecs = specs_pair([dict(sim_seed=s) for s in range(3)])
    tres = [s.resolve() for s in tspecs]
    assert all(r.fed is tres[0].fed for r in tres)
    prog = tsweep.build_sweep(tres, tparams, device="cpu")
    assert prog.dyn == {}
    fed = tres[0].fed
    assert tuple(prog.data.x.shape) == fed.x.shape
    assert prog.data.x.untyped_storage().nbytes() == fed.x.nbytes
    assert prog.data.rsu_assign.dim() == 1
    hists = run_scenarios(tres, tparams, device="cpu")
    for spec, h in zip(tspecs, hists):
        np.testing.assert_array_equal(
            h["acc"], run_scenario(spec, tparams, device="cpu")[1]["acc"])


def test_max_sweep_tail_padding_reuses_the_program(params):
    """5 cells at max_sweep 2: chunks of 2, 2 and a tail of 1 padded to 2
    with a copy of its last cell; one build, histories in input order."""
    _, tparams = params
    _, tspecs = specs_pair([dict(hp=dict(mu1=0.004 * i), sim_seed=i)
                            for i in range(5)])
    program_cache.clear()
    hists = run_scenarios(tspecs, tparams, device="cpu", max_sweep=2)
    assert program_cache.trace_count("sweep_round") == 1
    assert program_cache.stats()["hits"] == 2
    assert len(hists) == 5
    whole = run_scenarios(tspecs, tparams, device="cpu")
    for a, b in zip(hists, whole):
        np.testing.assert_allclose(a["acc"], b["acc"], atol=2e-3)
    np.testing.assert_array_equal(
        hists[4]["acc"], run_scenario(tspecs[4], tparams,
                                      device="cpu")[1]["acc"])


def test_singleton_runs_through_the_cached_program(params):
    """A lone spec runs as a one-cell sweep; its re-run builds nothing, and
    ``program_cache=False`` never touches the registry."""
    _, tparams = params
    _, (spec,) = specs_pair([dict(sim_seed=4)])
    program_cache.clear()
    first = run_scenarios([spec], tparams, device="cpu")
    again = run_scenarios([spec], tparams, device="cpu")
    assert program_cache.trace_count("sweep_round") == 1
    assert program_cache.stats()["hits"] == 1
    np.testing.assert_array_equal(first[0]["acc"], again[0]["acc"])
    np.testing.assert_array_equal(
        first[0]["acc"], run_scenario(spec, tparams, device="cpu")[1]["acc"])
    entries = program_cache.stats()["entries"]
    run_scenarios([spec.replace(program_cache=False)], tparams, device="cpu")
    assert program_cache.stats()["entries"] == entries
    assert program_cache.trace_count("sweep_round") == 2


def test_grouping_on_static_key_keeps_input_order(params):
    """flat and async cells, and two fleet shapes, in one grid: separate
    groups, histories in input order, each equal to its sequential run."""
    _, tparams = params
    _, tspecs = specs_pair([dict(sim_seed=1), dict(engine="async"),
                            dict(n_agents=6), dict(sim_seed=2)])
    tres = [s.resolve() for s in tspecs]
    assert tsweep.group_indices(tres) == [[0, 3], [1], [2]]
    assert tres[0].static_key == tres[3].static_key != tres[1].static_key
    hists = run_scenarios(tres, tparams, device="cpu")
    for spec, h in zip(tspecs, hists):
        np.testing.assert_array_equal(
            h["acc"], run_scenario(spec, tparams, device="cpu")[1]["acc"])


def test_refused_engine_raises(params):
    """The engines the port does not run are refused by name, in a grid as
    alone; a group handed to build_sweep must be one sweepable group."""
    _, tparams = params
    with pytest.raises(NotImplementedError, match="tree"):
        run_scenarios([TSpec(**BASE), TSpec(**BASE, engine="tree")],
                      tparams, device="cpu")
    tres = [TSpec(**BASE).resolve(), TSpec(**dict(BASE, n_agents=6)).resolve()]
    with pytest.raises(ValueError, match="static_key"):
        tsweep.build_sweep(tres, tparams, device="cpu")
    assert tsweep.sweep_mesh(16) is None


def test_static_key_matches_the_reference():
    """The port groups exactly as the reference does: equal static keys
    for equal cells, the same fields, and the resolve caches share one
    FederatedData across a partition's specs."""
    jspecs, tspecs = specs_pair([
        dict(sim_seed=1, het=dict(csr=0.4), hp=dict(lar=3, mu1=0.02)),
        dict(faults=fault_plans()[0], engine="async", cloud_every=3)])
    for j, t in zip(jspecs, tspecs):
        assert t.resolve().static_key == j.resolve().static_key
    from repro_torch.core import scenario as tscenario
    a, b = tspecs[0].resolve(), tspecs[0].replace(sim_seed=9).resolve()
    assert a.fed is b.fed and a.test is b.test
    tscenario.clear_caches()
    assert tspecs[0].resolve().fed is not a.fed

